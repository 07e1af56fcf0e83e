#!/usr/bin/env python3
"""Prove on one NVIDIA GPU that the PyTorch/CUDA port's main paths run, and
run through its hand-written kernels.

Run from the root of a checkout, on a machine with a CUDA device and nvcc::

    python3 chip_smoke.py           # about fifteen minutes on an H100

Phases (any failure exits non-zero, and no phase carries on past its own
failure):

1. the card (``nvidia-smi`` name and power limit) and the toolchain;
2. build the kernels from ``energybalancemodel_jl_tpu_torch/csrc`` (one nvcc
   per source, in parallel), print each kernel's registers, and hold the MIZ
   builds of the canonical grid, and every Classic and K11 build (the block
   builds and the warp builds, one member or system per warp), to the blocks
   or members per SM their design names;
3. the MIZ kernel against its plain PyTorch version on the card: a small
   grid point by point in float64 and float32 (raw-collected year included),
   the canonical grid at the main path's width point by point with fixed
   Newton iterations and by year-level hemispheric means with the adaptive
   Newton, members against solo runs bitwise, and ``years_per_dispatch``
   chunking;
4. the MIZ main path: a K=8192 canonical MIZ ensemble, float32, fused engine;
5. a single canonical MIZ run through ``integrate`` with ``engine='auto'``,
   every year (the raw-collected last one too) through the kernel;
6. the MIZ kernel timed per model year on the canonical grid at K=1 and
   K=8192, f32 and f64 (each member's Newton updates counted, and held to
   the counts pinned in ``NEWTON_UPDATES``),
   the kernel's raw-collected year at K=1, and the plain version at K=8192
   f32;
7. the Classic kernel against its plain version, bitwise: nx=40/nt=1000
   K=8 with D, S1 and F swept (f64 and f32, warm init and zeros on the warp
   builds, warm init on the block build too; 2 years, the second
   raw-collected), the canonical grid at K=8192, the nx=4096 single run, and
   members against solo runs;
8. the Classic main path: a K=8192 canonical ensemble (``engine='auto'``)
   and a 3-year single run through ``integrate`` (3 launches);
9. the batched PCR (K11) and the fixed-iteration Newton for T0 (K10)
   against their plain versions bitwise at the canonical (8192, 180), then
   one canonical MIZ year on ``ensemble_integrate(engine='batched')`` with
   ``solver='pcr_fused'`` and with ``solver='pallas'``;
10. the Classic kernel timed per model year on both builds at the K around
    its dispatch (``ops/classic_year.py::WARP_MIN_K``), then as the kernel
    picks (K=1, K=8192, f32, f64; the plain version at K=8192 f32), and the
    K11 and K10 kernels per wrapper call and per kernel on the device, each
    beside its plain version;
11. the draw kernel against its plain version, bitwise: all 2^23 mantissas
    the pipeline can see, and the (2000, 8192) table of seed 0; the float64
    draws (plain PyTorch) on the card against the CPU's, bitwise;
12. every noise mode of the MIZ and Classic kernels (table, table/OU,
    keys/serial, keys/assoc, crossing) against its plain version at nx=40,
    and sigma = 0 against the deterministic kernel at the main path's shape
    (the same Newton updates too);
13. the main path: ``transitions`` on the canonical MIZ grid at K=8192 from
    two states of 40-year ``integrate`` runs (f32 keys/serial 3 years,
    keys/assoc 1 year, subyear 2 years, f64 table/OU 1 year), launches
    counted per mode; then the same for Classic, with the scan engine, whose
    draws come from the draw kernel;
14. every mode that phase 13 runs (f32 keys/serial, keys/assoc, crossing,
    f64 table/OU) and K5's table, MIZ and Classic, against its plain version
    at the main path's shape and on its first year's inputs, bitwise (MIZ
    with fixed Newton iterations): the kernel runs all K=8192 members, the
    plain version 64 of them spread over the ensemble, each with its own
    keys, OU row, noise column and threshold, in three plain years per model
    run at once in processes of their own (members are independent); then
    every mode timed per canonical model
    year at K=8192 in the dtype its path runs (table/OU in float32 too),
    beside the deterministic kernel in the same call, with each member's
    Newton updates counted; the draw kernel per call;
15. the equilibrium layer's main path: ``equilibrate`` of 8192 canonical MIZ
    members (f32, the forcing offset F swept over [-10, 10], tol 5e-2, at
    most 150 years), one ``miz_year`` launch per simulated year, the first
    256 members bitwise equal to ``ensemble_integrate(engine='fused')`` of
    them, every member finite, every member that reads converged within tol;
    the loop's host overhead per year beside the kernel's device time
    (torch.profiler);
16. Classic ``equilibrate`` at the same width (tol 0.5), a single-run MIZ
    ``continuation`` over F in {-10, -5, 0, 5, 10} and back, and MIZ float64
    at K=64 to tol 1e-6 with Anderson acceleration and with Picard, every
    member finite;
17. gradients on the card, six jobs in processes of their own, beside
    phase 16's float64 pair: the eager year's d/dD (float64, canonical, from
    the continuation's F=0 state) against central differences at two steps
    (four members of one launch of the year kernel), ``stability`` on both
    sides there, ``sensitivity`` at ``SpaceTime.sin(8, 50)``, and the
    differentiable fixed point at ``SpaceTime.sin(8, 100)`` on the card and
    on the CPU, held leaf by leaf; then the kernel wrappers refuse inputs
    that require grad;
18. the search drivers' main path: ``fold`` of 8192 Classic members at the
    canonical grid (f32, D swept over [0.3, 0.9], the warm init, F bisected
    in [-10, 20] over 6 steps at tol 0.5), one ``classic_year`` launch per
    simulated year of its solves, every final bracket 30/64 wide, the last
    probe's first 64 members bitwise equal to their run alone (the block
    build), and how many of their decisions a K=64 fold reproduces;
19. the Classic bistable window above phase 18's fold at the default D
    (a warm and a cold state equilibrated over 64 forcing levels), then
    ``basins`` of 8192 blends of the settled states at its middle (two
    attractors, every converged member labelled, members 0, K-1 and the
    first of the other attractor bitwise equal to their runs alone) and
    ``edge`` of 8192 members with the forcing swept across the window (6
    steps, the warp build), launches counted as in phase 18;
20. the solo and eager drivers at the JAX package's own diagnostic grids
    (the dense polish refuses grids past ``basins._POLISH_UNIT_CAP``, and
    the eager year is launch-bound on the card), f64, each job in a process
    of its own, queued in phase 17's pool behind its jobs (they run on the
    workers phase 17's shorter jobs free; their holds are read here):
    ``edge_state`` near the Classic saddle at
    ``SpaceTime.sin(8, 1000)``, F=10 (converged, its ice area between the
    attractors', exactly one eigenvalue of the dense year-map Jacobian
    outside the unit circle), a 2-level ``unstable_branch`` there,
    ``lyapunov`` at the ice-free Classic equilibrium against ``stability``'s
    log growth (1e-6), and a MIZ ``lyapunov`` (``SpaceTime.sin(24, 400)``,
    K=64, ``member_chunk=16``, ``project=("Ew", "phi")``) on the card
    against the same run on the CPU (1e-10);
21. checkpoints on the main paths, each run interrupted by a writer that
    raises once the chosen year is on disk, then resumed: the phase 4
    ensemble over 4 years (a checkpoint every year, interrupted after year
    2), a Classic ``integrate`` single run over 3 years under a
    warming-cooling ramp (the block build, interrupted after year 1), and a
    Picard ``equilibrate`` of 8192 MIZ members over 8 years (tol 0,
    interrupted after year 4); each resume makes exactly the remaining
    years' launches, and its final carry (the Newton warm start ``T0``
    included) and every seasonal store equal the uninterrupted run's
    bitwise; then ``save`` and ``load`` of the ensemble's and
    ``equilibrate``'s results (every array bitwise), and ``plot_avg`` and
    ``plot_seasonal`` of the Classic run to PNG under Agg where matplotlib
    is installed; each checkpoint write's seconds and file size;
22. the high-resolution runs on the kernels' wide builds (every one a
    cluster build: a thread-block cluster per member or system, the PCR rows
    and the neighbour exchange in the blocks' shared memory): the Classic
    year against its plain version,
    bitwise, at nx 8192 and 32768 (K=1, nt=1000, raw-collected, f32 and
    f64) and with more members than the card keeps clusters resident (each
    cluster loops over members; three members bitwise their solo runs), the
    MIZ year at nx 1536, 2048 and 16384 (nt=64, D scaled to the canonical D
    nx^2/nt, 2 fixed Newton iterations, raw-collected, f32 and f64), at the
    main path's nx 1536 also with the default Newton tolerances (the
    kernel's Newton updates equal the plain version's) and with more members
    than clusters resident, every noise mode of both at nx 8192 / 2048, K11
    at (64, 32768) and K10 at (64, 16384) at every C that fits and as the C
    side chooses, f32 and f64, with more systems than clusters resident
    (with ``tridiag_matvec``'s residual), each wide build held to no spill
    stores in phase 2; each
    cluster build's plan (C, threads, shared bytes, resident clusters,
    registers); then the main paths:
    ``integrate('Classic', SpaceTime.sin(32768, 1000, 2))`` under a ramp
    with ``engine='auto'`` and checkpoints, interrupted after year 1 and
    resumed bitwise (2 + 1 launches), ``integrate('MIZ',
    SpaceTime.sin(1536, 147456, 1), raw_mode='none')`` (1 launch, every
    store finite), and the batched engine at the wide widths through K11
    and K10;
23. the multi-device layer on a mesh of four shards on the card (a device
    repeated: a thread and a CUDA stream per shard): ``ensemble_integrate
    (mesh=)`` MIZ and Classic at the main path's shape (K=8192, f32, one
    year; one kernel launch per shard) and ``transitions(mesh=)`` in the
    keys mode, each bitwise its unsharded run; SPIKE and the sharded stencil
    at n=32768 against ``pcr_solve`` and ``diffusion``; ``spatial_integrate``
    MIZ at ``SpaceTime.sin(16384, 64, 1)`` (f64, D scaled) and
    ``ensemble_spatial_integrate`` on a (2, 2) mesh (K=64,
    ``SpaceTime.sin(2048, 64, 1)``) against the unsharded eager runs at the
    JAX package's bars (rtol 1e-8, atol 1e-9); each path's wall beside the
    unsharded one; the script's total seconds.

The line before the last is the kernel table as JSON (each kernel's time,
plain time, launches on its path, the least time the card could take for its
work, ``bound_ms``, and a library call's time where one PyTorch call computes
the same function; ``launches_mesh``: its launches on phase 23's paths); the
last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np

CANONICAL = (180, 2000)  # SpaceTime.sin(nx, nt, dur), bench.py's grid
K_MAIN = 8192
# phase 14: the members of the K_MAIN ensemble that its plain years hold
HOLD_MEMBERS = 64
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


_T0 = time.perf_counter()


def say(phase, msg):
    print(f"[{phase}] ({time.perf_counter() - _T0:.0f} s) {msg}", flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# Blocks of 192 threads (the canonical nx = 180) that share an SM, by the
# registers of the MIZ year kernel's 192-thread builds (csrc/miz_year.cu):
# 65,536 registers per SM, allocated per warp in units of 8 per thread
MIZ_BLOCKS_PER_SM = {("f32", "det"): 6, ("f32", "noisy"): 5, ("f64", "det"): 2,
                     ("f64", "noisy"): 2}


# Newton updates of all members over one canonical year, as the kernel counted
# them with XLA:CPU's fused multiply-adds at their sites (NVIDIA H100; the
# arithmetic is deterministic, so a change to how values move between
# threads must change no iterate, and every count is held exactly; a change
# of the arithmetic itself changes them). Keys: phase 6 (dtype, K) from zero
# init; phase 14 by mode, from the ice-free state of 40 years at F=+15
NEWTON_UPDATES = {("float32", 8192): 18762098, ("float32", 1): 2299,
                  ("float64", 8192): 18740528, "det": 6455296, "sigma0": 6455296,
                  "keys/serial": 11199140, "keys/crossing": 11199140}


def check_miz_occupancy(ptxas):
    """Fail when a 192-thread MIZ build (``miz_year_kernel<dtype, 192, blocks,
    NOISY, COUNT>`` in ``tools.kernel_times.ptxas_rows``) uses more registers
    than its blocks per SM allow; returns the blocks per SM of each build."""
    found = {}
    for name, used in ptxas.items():
        m = re.match(r"miz_year_kernel<(f32|f64),192,\d+,([01]),([01])>", name)
        if not m:
            continue
        regs = -(-int(used.split()[0]) // 8) * 8
        blocks = 65536 // (regs * 192)
        kind = "noisy" if m.group(2) == "1" else "det"
        found[m.group(1), kind, m.group(3) == "1"] = blocks
        want = MIZ_BLOCKS_PER_SM[m.group(1), kind]
        if blocks < want:
            fail(f"{name}: {used}, {blocks} blocks of 192 threads per SM, the design needs "
                 f"{want}")
    if len(found) != 8:
        fail(f"expected 8 MIZ builds of 192 threads in the ptxas log, found {sorted(found)}")
    return found


# The Classic and K11 builds (csrc/classic_year.cu, csrc/pcr.cu) and the
# members (systems) per SM each design names: a block build keeps one member
# per block and is held to the blocks of its template (192 threads: 5 in
# float32, 3 in float64, 2 noisy float64); a warp build keeps WARPS members
# per block and is held to the blocks its __launch_bounds__ name. Registers
# are allocated per warp in units of 8 per thread, 65,536 per SM.
def members_per_sm(regs, threads_per_block, members_per_block):
    per_warp = -(-regs // 8) * 8 * 32
    blocks = (65536 // per_warp) // (threads_per_block // 32)
    return blocks * members_per_block


def check_classic_occupancy(ptxas):
    """Fail when a Classic or K11 build keeps fewer members per SM than its
    design names; returns ``{build: (registers, members per SM, design)}``."""
    found = {}
    for name, used in ptxas.items():
        regs = int(used.split()[0])
        m = re.match(r"classic_year_kernel<(f32|f64),1,192,(\d+),([01])>", name)
        if m:
            found[name] = regs, members_per_sm(regs, 192, 1), int(m.group(2))
        m = re.match(r"classic_warp_kernel<(f32|f64),(\d+),(\d+),(\d+),([01]),([01])>", name)
        if m:
            warps, blocks = int(m.group(3)), int(m.group(4))
            found[name] = regs, members_per_sm(regs, 32 * warps, warps), warps * blocks
        m = re.match(r"pcr_warp_kernel<(f32|f64),(\d+),(\d+),(\d+)>", name)
        if m:
            warps, blocks = int(m.group(3)), int(m.group(4))
            found[name] = regs, members_per_sm(regs, 32 * warps, warps), warps * blocks
    for name, (regs, members, want) in found.items():
        if members < want:
            fail(f"{name}: {regs} registers, {members} members per SM, the design needs {want}")
    kinds = {n.split("<")[0] for n in found}
    if kinds != {"classic_year_kernel", "classic_warp_kernel", "pcr_warp_kernel"}:
        fail(f"Classic and K11 builds missing from the ptxas log: found {sorted(found)}")
    return found


# the wide builds, every one a cluster build (csrc/cluster.cuh): Classic and
# MIZ by dtype and noise (MIZ by its count output too), K11 and K10 by dtype,
# each held to no spill stores: every per-cell value lives in a record, so
# the registers hold one cell's work at a time
WIDE_BUILDS = {"classic_cluster_kernel": 4, "miz_cluster_kernel": 8, "pcr_cluster_kernel": 2,
               "newton_t0_cluster_kernel": 2}


def check_wide_builds(ptxas):
    """Fail when a wide build is missing from the ptxas log or spills;
    returns ``{build: ptxas line}``."""
    found = {name: used for name, used in ptxas.items()
             if "_wide_kernel" in name or "_cluster_kernel" in name}
    counts = {k: sum(name.startswith(k + "<") for name in found) for k in WIDE_BUILDS}
    if counts != WIDE_BUILDS:
        fail(f"wide builds in the ptxas log: {counts}, expected {WIDE_BUILDS}")
    for name, used in found.items():
        if "spilled" in used:
            fail(f"{name}: {used}; a wide build keeps its cells in the workspace and must not "
                 "spill")
    return found


# tolerances of the equilibrium phases: f32 at the canonical grid converges
# to the solver-noise floor (JAX equilibrium.py:664-669: Picard, tol 5e-2);
# Classic's albedo-hole wobble keeps its residual near 0.1 (tol 0.5)
EQ_TOL_MIZ, EQ_TOL_CLASSIC, EQ_MAX_YEARS = 5e-2, 0.5, 150
# the gradient holds: a finite difference at the bar of
# tests/test_gradients.py:49 (called with 1e-3); the fixed point's gradient
# on the card against the CPU's
BAR_FD = 1e-3
FD_STEPS = (1e-6, 1e-7)  # both held
BAR_CARD_CPU = 1e-9


def equilibrium_phases(dev, smi, search_init=None):
    """Phases 15-17: the equilibrium layer on the card. Returns the launch
    counts and times the kernel table reports for the year kernels. Phase
    17's jobs start once the continuation has given their state, and run
    beside phase 16's float64 pair (a K=64 year keeps the card and the host
    mostly idle). With ``search_init`` (:func:`search_init_state`), phase
    20's jobs queue behind phase 17's in its pool, on the workers its
    shorter jobs free, and their results come back under
    ``"search_jobs"``."""
    out = phase15(dev, smi)
    out.update(phase16(dev, smi))
    out["search_jobs"] = phase17(dev, smi, out.pop("f0_state"),
                                 meanwhile=lambda: phase16_f64(dev, smi),
                                 search_init=search_init)
    return out


def _lost_members(res):
    """Per member (one for a single run): True where the carry or a seasonal
    store holds a value that is not finite (presentation NaNs aside)."""
    lost = np.zeros(1 if res.member_years is None else len(res.member_years), bool)
    for name, coll in (("state", res.state), *zip(("winter", "summer", "avg"), res.seasonal)):
        for k, v in coll.items():
            ok = np.isfinite(v) | (np.isnan(v) & (k in ("Ti", "Tw")) & (name != "state"))
            lost |= ~ok.all(-1)
    return lost


def _timed_run(fn, counter, kernel):
    """``(result, wall seconds, launches, device seconds of the kernels whose
    name holds kernel)``: torch.profiler, None when it records no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    counter.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = sum(getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
                 for e in prof.key_averages() if kernel in e.key)
    return res, wall, counter.launches, (dev_us / 1e6 if dev_us else None)


def phase15(dev, smi):
    """MIZ equilibrate at the main path's full width."""
    import torch

    import energybalancemodel_jl_tpu_torch as ebt
    from energybalancemodel_jl_tpu_torch.ops.miz_year import miz_year

    out = {}
    st = ebt.SpaceTime.sin(*CANONICAL, 1)
    sweep = np.linspace(-10.0, 10.0, K_MAIN)
    # -- 15. MIZ equilibrate at full width ------------------------------------
    par = ebt.default_parameters("MIZ")
    par["F"] = sweep
    eq, wall, launches, kern_s = _timed_run(
        lambda: ebt.equilibrate("MIZ", st, 0.0, par, ebt.zeros_init(st), tol=EQ_TOL_MIZ,
                                max_years=EQ_MAX_YEARS, dtype="float32", device=dev),
        miz_year, "miz_year")
    if launches != eq.years:
        fail(f"MIZ equilibrate: {launches} miz_year launches for {eq.years} years")
    # every member finite (the residual counts NaN as 0, JAX
    # equilibrium.py:124-130, so a lost member could read converged), and
    # every member that reads converged within tol
    lost = _lost_members(eq)
    if lost.any():
        fail(f"MIZ equilibrate: {int(lost.sum())} of {K_MAIN} members non-finite, F = "
             + ", ".join(f"{F:.6f}" for F in sweep[lost][:8]))
    if not np.all(eq.resid[eq.converged] <= EQ_TOL_MIZ):
        fail("MIZ equilibrate: a member reads converged above tol")
    n = 256  # the first members against ensemble_integrate of them, bitwise
    ens = ebt.ensemble_integrate("MIZ", ebt.SpaceTime.sin(*CANONICAL, eq.years), ebt.Forcing(0.0),
                                 dict(par, F=sweep[:n]), ebt.zeros_init(st), engine="fused",
                                 dtype="float32", device=dev, progress=False)
    for name, a, b in zip(("winter", "summer", "avg"), eq.seasonal, ens.seasonal):
        for k in a:
            if not np.array_equal(a[k][:n], b[k][:, -1], equal_nan=True):
                fail(f"MIZ equilibrate: members 0..{n - 1} {name}.{k} differ from "
                     "ensemble_integrate's")
    per_year = wall / eq.years
    host_ms = (per_year - kern_s / eq.years) * 1e3 if kern_s is not None else None
    out["miz"] = dict(launches=launches, wall_ms_per_year=per_year * 1e3,
                      kernel_ms_per_year=kern_s / eq.years * 1e3 if kern_s is not None else None)
    say(15, json.dumps(dict(
        path="equilibrate('MIZ', SpaceTime.sin(180, 2000, 1), F swept over [-10, 10])",
        K=K_MAIN, dtype="float32", engine="auto (fused)", tol=EQ_TOL_MIZ,
        max_years=EQ_MAX_YEARS, years=eq.years, converged=int(np.count_nonzero(eq.converged)),
        member_years_max=int(eq.member_years.max()), miz_year_launches=launches,
        wall_s=wall, member_years_per_day=K_MAIN * eq.years / wall * 86400.0,
        kernel_ms_per_year=kern_s / eq.years * 1e3 if kern_s is not None else None,
        host_overhead_ms_per_year=host_ms, newton_ok=eq.newton_ok, gpu=smi)))
    say(15, f"members 0..{n - 1} equal ensemble_integrate(engine='fused') of them over "
            f"{eq.years} years, bitwise; all {K_MAIN} members finite; every member that "
            f"reads converged within {EQ_TOL_MIZ}")
    del eq, ens

    return out


def phase16(dev, smi):
    """Classic equilibrate and a MIZ continuation; returns the
    continuation's F=0 state for phase 17 (the float64 pair of phase 16 is
    :func:`phase16_f64`)."""
    import torch

    import energybalancemodel_jl_tpu_torch as ebt
    from energybalancemodel_jl_tpu_torch.ops.classic_year import classic_year
    from energybalancemodel_jl_tpu_torch.ops.miz_year import miz_year

    out = {}
    st = ebt.SpaceTime.sin(*CANONICAL, 1)
    sweep = np.linspace(-10.0, 10.0, K_MAIN)
    # -- 16. Classic equilibrate, a continuation, f64 Anderson vs Picard ------
    cpar = ebt.default_parameters("Classic")
    cpar["F"] = sweep
    E0 = np.full(CANONICAL[0], 30.0)
    warm = {"E": E0, "Tg": E0 / cpar["cw"]}
    ceq, wall, launches, kern_s = _timed_run(
        lambda: ebt.equilibrate("Classic", st, 0.0, cpar, warm, tol=EQ_TOL_CLASSIC,
                                max_years=EQ_MAX_YEARS, dtype="float32", device=dev),
        classic_year, "classic_")
    if launches != ceq.years or _lost_members(ceq).any():
        fail(f"Classic equilibrate: {launches} launches for {ceq.years} years, "
             f"{int(_lost_members(ceq).sum())} members non-finite")
    out["classic"] = dict(launches=launches, wall_ms_per_year=wall / ceq.years * 1e3,
                          kernel_ms_per_year=(kern_s / ceq.years * 1e3 if kern_s is not None
                                              else None))
    say(16, json.dumps(dict(
        path="equilibrate('Classic', SpaceTime.sin(180, 2000, 1), F swept over [-10, 10], "
             "warm init)", K=K_MAIN, dtype="float32", tol=EQ_TOL_CLASSIC, years=ceq.years,
        converged=int(np.count_nonzero(ceq.converged)), classic_year_launches=launches,
        wall_s=wall, member_years_per_day=K_MAIN * ceq.years / wall * 86400.0,
        kernel_ms_per_year=kern_s / ceq.years * 1e3 if kern_s is not None else None, gpu=smi)))
    del ceq

    levels = [-10.0, -5.0, 0.0, 5.0, 10.0]
    miz_year.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cont = ebt.continuation("MIZ", st, levels, ebt.default_parameters("MIZ"),
                            ebt.zeros_init(st), round_trip=True, tol=EQ_TOL_MIZ,
                            max_years=EQ_MAX_YEARS, dtype="float32", device=dev)
    wall = time.perf_counter() - t0
    if miz_year.launches != int(cont.years.sum()) or any(_lost_members(r).any() for r in cont.results):
        fail(f"continuation: {miz_year.launches} launches for {int(cont.years.sum())} years")
    out["continuation_launches"] = miz_year.launches
    gap_vals, gap = cont.hysteresis_gap()
    say(16, json.dumps(dict(
        path="continuation('MIZ', K=1, F in [-10, -5, 0, 5, 10], round_trip=True)",
        tol=EQ_TOL_MIZ, years=cont.years.tolist(), converged=cont.converged.tolist(),
        miz_year_launches=miz_year.launches, wall_s=wall,
        ice_area=[float(a) for a in cont.ice_area()],
        hysteresis_gap=dict(zip(map(float, gap_vals), map(float, gap))), gpu=smi)))
    out["f0_state"] = cont.results[levels.index(0.0)].state
    return out


def phase16_f64(dev, smi):
    """MIZ float64 at K=64 to tol 1e-6, Anderson against Picard."""
    import torch

    import energybalancemodel_jl_tpu_torch as ebt

    st = ebt.SpaceTime.sin(*CANONICAL, 1)
    par64 = ebt.default_parameters("MIZ")
    par64["F"] = np.linspace(-10.0, 10.0, 64)
    runs = {}
    for name, m in (("anderson=3", 3), ("picard", 0)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = ebt.equilibrate("MIZ", st, 0.0, par64, ebt.zeros_init(st), tol=1e-6, max_years=600,
                            anderson=m, dtype="float64", device=dev)
        lost = _lost_members(r)
        runs[name] = dict(years=r.years, converged=int(np.count_nonzero(r.converged)),
                          member_years_max=int(r.member_years.max()),
                          wall_s=time.perf_counter() - t0)
        if lost.any():
            fail(f"MIZ f64 equilibrate ({name}): {int(lost.sum())} of 64 members non-finite")
        if not np.all(r.resid[r.converged] <= 1e-6):
            fail(f"MIZ f64 equilibrate ({name}): a member reads converged above tol")
    say(16, json.dumps(dict(path="equilibrate('MIZ', K=64, float64, tol=1e-6, max_years=600)",
                            runs=runs, note="beside phase 17's jobs", gpu=smi)))


def _gradient_task(task, f0_state):
    """One gradient job of phase 17, run in a process of its own: the eager
    float64 year is bound by the host's launches (one core each), so the jobs
    overlap. Returns a dict, with ``"error"`` when a hold failed. A gradient
    leaf of the fixed point that never had a finite increment (returned as
    0, with a warning) is an error here."""
    import warnings

    import torch

    import energybalancemodel_jl_tpu_torch as ebt
    from energybalancemodel_jl_tpu_torch.equilibrium import make_equilibrium_seasonal_fn
    from energybalancemodel_jl_tpu_torch.integrate import make_year_fn
    from energybalancemodel_jl_tpu_torch.models.base import default_step_config, get_model
    from energybalancemodel_jl_tpu_torch.ops.miz_year import miz_year

    torch.set_num_threads(1)
    warnings.filterwarnings("error", message="the fixed point's gradient")
    f64, cfg64 = torch.float64, default_step_config("float64")
    dev = torch.device("cpu") if task == "fixed point cpu" else torch.device("cuda", 0)
    st = ebt.SpaceTime.sin(*CANONICAL, 1)
    state64 = {k: np.asarray(v, dtype=np.float64) for k, v in (f0_state or {}).items()}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    if task == "year gradient":
        year = make_year_fn("MIZ", st, cfg64, False)
        base = {k: torch.tensor(float(v), dtype=f64, device=dev)
                for k, v in ebt.default_parameters("MIZ").items()}
        # from the continuation's F=0 state: a year from zero init starts on
        # the E = 0 switches, where the derivative is ill-conditioned at this
        # grid (tests/test_torch_gradients.py holds reverse mode from zero
        # init against jax.grad on a small grid)
        carry0 = get_model("MIZ").init_carry(state64, st, f64, dev)
        frow = torch.zeros(st.nt, dtype=f64, device=dev)

        def loss(D):
            return torch.nan_to_num(year(carry0, dict(base, D=D), frow)[1].avg["E"]).sum()

        D = torch.tensor(0.6, dtype=f64, device=dev, requires_grad=True)
        g = float(torch.autograd.grad(loss(D), D)[0])
        sync()
        grad_s = time.perf_counter() - t0
        # central differences at two steps, the year piecewise smooth (its
        # min/max and masks switch cells' regimes): the values D +- step of
        # both steps are four members of one launch of the year kernel (the
        # same year map, held to its plain version elsewhere in this script;
        # an eager year here costs a minute)
        Ds = [0.6 + eps for eps in FD_STEPS] + [0.6 - eps for eps in FD_STEPS]
        kcarry = ebt.Collection({k: v[None].expand(len(Ds), -1).contiguous()
                                 for k, v in carry0.items()})
        seas = miz_year(kcarry, dict(ebt.default_parameters("MIZ"), D=np.array(Ds)), frow,
                        st, cfg64)[1]
        L = torch.nan_to_num(seas.avg["E"]).sum(-1).cpu().numpy()
        n = len(FD_STEPS)
        fd = {eps: float((L[i] - L[n + i]) / (2 * eps)) for i, eps in enumerate(FD_STEPS)}
        out = dict(grad=g, fd=fd, rel={eps: abs(g - d) / abs(d) for eps, d in fd.items()},
                   grad_s=grad_s)
        if not (np.isfinite(g) and all(abs(g - d) <= BAR_FD * abs(d) for d in fd.values())):
            out["error"] = f"year gradient d/dD {g} against the central differences {fd}"
    elif task.startswith("stability"):
        side = task.split()[1]
        r = ebt.stability("MIZ", st, 0.0, ebt.default_parameters("MIZ"), state64, n_iter=2,
                          side=side, dtype="float64", device=dev)
        out = dict(growth=r.growth, eigenvalue=r.eigenvalues, history=r.history.tolist())
        if not np.isfinite(r.growth):
            out["error"] = f"stability side={side}: growth {r.growth}"
    elif task.startswith("fixed point"):
        st8 = ebt.SpaceTime.sin(8, 100, 1)
        # the adjoint capped at 40 iterations, as the CPU tests cap it: card and
        # CPU run the same iterations, and the card's eager years share it with
        # the other jobs
        fn = make_equilibrium_seasonal_fn("MIZ", st8, cfg64, "float64", bwd_max_iters=40)
        p = {k: torch.tensor(float(v), dtype=f64, device=dev, requires_grad=True)
             for k, v in ebt.default_parameters("MIZ").items()}
        fr = torch.full((st8.nt,), 4.0, dtype=f64, device=dev, requires_grad=True)
        c0 = get_model("MIZ").init_carry(ebt.zeros_init(st8), st8, f64, dev)
        area = 2.0 * np.pi * ebt.hemispheric_mean(
            torch.nan_to_num(fn(p, fr, c0).avg["phi"]), st8.x)
        gr = torch.autograd.grad(area, list(p.values()) + [fr])
        # by name: the two sides run in processes of their own
        out = dict(values={"value": float(area.detach()),
                           **{f"d/d{k}": float(g) for k, g in zip(p, gr[:-1])},
                           "d/dforcing": gr[-1].detach().cpu().numpy()})
    elif task == "sensitivity":
        st50 = ebt.SpaceTime.sin(8, 50, 1)
        sens = ebt.sensitivity("MIZ", st50, 4.0, ebt.default_parameters("MIZ"),
                               ebt.zeros_init(st50), dtype="float64", device=dev)
        out = dict(value=sens.value, top=[(k, float(g)) for k, g, _ in sens.top(3)])
        if not all(np.isfinite(v) for v in sens.grads.values()):
            out["error"] = "sensitivity on the card: a non-finite gradient"
    sync()
    out["wall_s"] = time.perf_counter() - t0
    return out


# each in a process of its own: one after the other they would not fit the
# script's 900 s target (each job's seconds are printed)
GRADIENT_TASKS = ("year gradient", "stability adjoint", "stability right", "sensitivity",
                  "fixed point cpu", "fixed point cuda")


def phase17(dev, smi, f0_state, meanwhile, search_init=None):
    """Gradients on the card, each job in a process of its own (all joined
    before this returns; ``meanwhile()`` runs in this process while they
    do): the eager year's gradient against central differences,
    ``stability`` both sides, ``sensitivity``, and the fixed point's gradient
    on the card against the CPU's; then the wrappers' refusals. With
    ``search_init``, phase 20's jobs queue in the same pool; returns their
    results (None without)."""
    import multiprocessing

    import torch

    import energybalancemodel_jl_tpu_torch as ebt
    from energybalancemodel_jl_tpu_torch.models.base import default_step_config
    from energybalancemodel_jl_tpu_torch.ops.classic_year import classic_year
    from energybalancemodel_jl_tpu_torch.ops.miz_year import CARRY_KEYS, miz_year
    from energybalancemodel_jl_tpu_torch.ops.newton_t0 import newton_t0
    from energybalancemodel_jl_tpu_torch.ops.pcr_fused import pcr_fused

    t0 = time.perf_counter()
    search = None
    with multiprocessing.get_context("spawn").Pool(len(GRADIENT_TASKS)) as pool:
        pending = pool.starmap_async(_gradient_task,
                                     [(task, f0_state) for task in GRADIENT_TASKS])
        if search_init is not None:
            queued = pool.starmap_async(_search_task,
                                        [(task, search_init) for task in SEARCH_TASKS])
        meanwhile()
        results = dict(zip(GRADIENT_TASKS, pending.get()))
        wall = time.perf_counter() - t0
        if search_init is not None:
            search = dict(zip(SEARCH_TASKS, queued.get()))
            say(17, f"phase 20's jobs, queued behind these: done "
                    f"{time.perf_counter() - t0:.1f} s after the pool started")
    for task, r in results.items():
        if "error" in r:
            fail(f"phase 17 {task}: {r['error']}")
    g = results["year gradient"]
    say(17, f"make_year_fn('MIZ') canonical K=1 f64 from the continuation's F=0 state, "
            f"d sum(avg E)/dD: {g['grad']:.10e}; central differences (the year kernel): "
            + ", ".join(f"step {eps:g} {g['fd'][eps]:.10e} rel {g['rel'][eps]:.3e}"
                        for eps in FD_STEPS)
            + f" (bar {BAR_FD} at both); forward and backward "
            f"{g['grad_s']:.3f} s")
    stab = {side: dict(results[f"stability {side}"],
                       s_per_iteration=results[f"stability {side}"]["wall_s"] / 3)
            for side in ("adjoint", "right")}
    say(17, json.dumps(dict(path="stability('MIZ', canonical K=1, the F=0 state of the "
                                 "continuation as f64, n_iter=2)", sides=stab, gpu=smi)))
    a = results["fixed point cpu"]["values"]
    b = results["fixed point cuda"]["values"]
    if a.keys() != b.keys():
        fail("make_equilibrium_seasonal_fn: the card's and the CPU's gradients name different "
             "leaves")
    worst, worst_at = 0.0, None
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        r = float(np.max(np.abs(x - y) / np.maximum(np.abs(x), 1e-300)))
        if r >= worst:
            worst, worst_at = r, k
        if not np.all(np.abs(x - y) <= BAR_CARD_CPU * np.abs(x) + 1e-15):
            fail(f"make_equilibrium_seasonal_fn on the card differs from the CPU's at {k}: "
                 f"{y} against {x}")
    say(17, f"make_equilibrium_seasonal_fn('MIZ', SpaceTime.sin(8, 100), forcing 4, "
            f"bwd_max_iters=40): value and every gradient on the card equal the CPU's to "
            f"rel {worst:.3e} (at {worst_at}; bar {BAR_CARD_CPU} + 1e-15 absolute), each "
            f"side in a process of its own; seconds card "
            f"{results['fixed point cuda']['wall_s']:.3f}, cpu "
            f"{results['fixed point cpu']['wall_s']:.3f}")
    sens = results["sensitivity"]
    say(17, f"sensitivity('MIZ', SpaceTime.sin(8, 50), forcing 4, JAX's defaults) on the card: "
            f"{sens['wall_s']:.3f} s; ice area {sens['value']:.10f}; top "
            + ", ".join(f"{k} {v:.6e}" for k, v in sens["top"]))
    say(17, f"the gradient jobs ({len(GRADIENT_TASKS)} in processes of their own): "
            f"{wall:.1f} s wall, "
            + ", ".join(f"{task} {r['wall_s']:.1f} s" for task, r in results.items()))

    z = lambda *shape: torch.zeros(shape, device=dev)
    refused = 0
    for label, call in (
            ("miz_year", lambda: miz_year(
                ebt.Collection({k: z(1, 16) for k in CARRY_KEYS}),
                dict(ebt.default_parameters("MIZ"),
                     D=torch.tensor([0.6], device=dev, requires_grad=True)),
                z(100), ebt.SpaceTime.sin(16, 100, 1), default_step_config("float32"))),
            ("classic_year", lambda: classic_year(
                ebt.Collection(E=z(1, 16).requires_grad_(True), Tg=z(1, 16)),
                ebt.default_parameters("Classic"), z(100), ebt.SpaceTime.sin(16, 100, 1),
                default_step_config("float32"))),
            ("pcr_fused", lambda: pcr_fused(z(4, 16), z(4, 16) + 1.0, z(4, 16),
                                            z(4, 16).requires_grad_(True))),
            ("newton_t0", lambda: newton_t0(z(4, 16).requires_grad_(True), z(4, 16) + 1.0,
                                            z(4, 16), z(4, 16), z(4, 16), z(16), z(16), z(16),
                                            0.6, 2.0, 0.0, 193.0, 2.1, 0.4, 0.0))):
        try:
            call()
        except ValueError as e:
            refused += "engine='batched'" in str(e)
        else:
            fail(f"{label} launched on an input that requires grad")
    if refused != 4:
        fail("a kernel wrapper refused an input that requires grad with the wrong message")
    say(17, "miz_year, classic_year, pcr_fused, newton_t0 refuse inputs that require grad")
    return search


# -- phases 18-20: the search and spectra drivers ----------------------------
# fold at the main path's width (phase 18): Classic, D swept over FOLD_D, the
# warm init, the bracket [FOLD_LO, FOLD_HI] in F, FOLD_STEPS bisections at
# tol 0.5; FOLD_MAX_YEARS is the anchor's year count at hi (35 on an NVIDIA
# H100 80GB HBM3 with a cap of 150: the smallest cap with which every
# member's anchor converges)
FOLD_D, FOLD_LO, FOLD_HI, FOLD_STEPS, FOLD_MAX_YEARS = (0.3, 0.9), -10.0, 20.0, 6, 35
# phase 19: the bistable window is scanned from the warm and the cold state
# over BISTABLE_SCAN levels above phase 18's fold at the default D; edge's
# probes stop at EDGE_MAX_YEARS (an unsettled probe is classified anyway and
# flagged in probe_converged)
BISTABLE_SCAN, BISTABLE_SPAN, EDGE_MAX_YEARS = 64, 30.0, 40
SOLO_MEMBERS = 64  # phase 18's rerun of the last probe, and its K=64 fold


class _SolveLog:
    """Wraps a driver module's ``equilibrate`` while in use: each call's
    simulated years, and the last call's arguments and result."""

    def __init__(self, module):
        self.module, self.years, self.last = module, [], None

    def __enter__(self):
        inner = self.orig = self.module.equilibrate

        def logged(*args, **kwargs):
            res = inner(*args, **kwargs)
            self.years.append(res.years)
            self.last = (args, kwargs, res)
            return res

        self.module.equilibrate = logged
        return self

    def __exit__(self, *exc):
        self.module.equilibrate = self.orig


def _same_state(a, b, n):
    """True when ``a`` (n members) equals the first n members of ``b``
    bitwise: the carry and the seasonal stores, NaNs in place."""
    pairs = [(a.state, b.state)] + list(zip(a.seasonal, b.seasonal))
    return all(np.array_equal(x[k], np.asarray(y[k])[:n], equal_nan=True)
               for x, y in pairs for k in x)


def phase18(dev, smi):
    """``fold`` of 8192 Classic members at the canonical grid."""
    import energybalancemodel_jl_tpu_torch as ebt
    from energybalancemodel_jl_tpu_torch.ops.classic_year import classic_year

    fold_mod = sys.modules["energybalancemodel_jl_tpu_torch.fold"]
    st = ebt.SpaceTime.sin(*CANONICAL, 1)
    par = ebt.default_parameters("Classic")
    par["D"] = np.linspace(*FOLD_D, K_MAIN)
    E0 = np.full(CANONICAL[0], 30.0)
    warm = {"E": E0, "Tg": E0 / par["cw"]}
    kw = dict(lo=FOLD_LO, hi=FOLD_HI, steps=FOLD_STEPS, tol=EQ_TOL_CLASSIC,
              max_years=FOLD_MAX_YEARS, dtype="float32", device=dev)
    with _SolveLog(fold_mod) as log:
        res, wall, launches, kern_s = _timed_run(
            lambda: ebt.fold("Classic", st, par, warm, **kw), classic_year, "classic_")
    years = sum(log.years)
    if launches != years:
        fail(f"fold: {launches} classic_year launches for {years} simulated years")
    width = (FOLD_HI - FOLD_LO) / 2 ** FOLD_STEPS
    if not np.array_equal(res.width, np.full(K_MAIN, width)):
        fail(f"fold: final brackets {np.unique(res.width)} wide, not {width}")
    # the last probe again, its first members alone (the block build), from
    # the same anchor state with the same values, for the same year count
    n = SOLO_MEMBERS
    (model, st_, forcing, p, state), _, last = log.last
    rerun = ebt.equilibrate(model, st_, forcing, {k: (v[:n] if np.ndim(v) else v)
                                                  for k, v in p.items()},
                            {k: v[:n] for k, v in state.items()}, tol=0.0,
                            max_years=last.years, dtype="float32", device=dev)
    if not _same_state(rerun, last, n):
        fail(f"fold: members 0..{n - 1} of the last probe differ from their run alone")
    small = ebt.fold("Classic", st, ebt.Collection(par, D=par["D"][:n]), warm, **kw)
    same = int(np.count_nonzero((small.survived == res.survived[:, :n]).all(0)))
    out = dict(launches=launches, years=years, kernel_ms_per_year=(
        kern_s / years * 1e3 if kern_s is not None else None), wall_s=wall)
    say(18, json.dumps(dict(
        path="fold('Classic', SpaceTime.sin(180, 2000, 1), D swept over [0.3, 0.9], warm init)",
        K=K_MAIN, dtype="float32", lo=FOLD_LO, hi=FOLD_HI, steps=FOLD_STEPS, tol=EQ_TOL_CLASSIC,
        max_years=FOLD_MAX_YEARS, anchor_years=res.anchor.years,
        anchor_member_years_max=int(res.anchor.member_years.max()),
        solve_years=log.years, classic_year_launches=launches, wall_s=wall,
        member_years_per_day=K_MAIN * years / wall * 86400.0,
        kernel_share=kern_s / wall if kern_s is not None else None,
        members_fully_converged=int(np.count_nonzero(res.ok)),
        fold_F_min_max=[float(res.values.min()), float(res.values.max())],
        fold_F_at_D=dict(zip(("0.3", "0.6", "0.9"), map(float, res.values[[0, K_MAIN // 2, -1]]))),
        gpu=smi)))
    say(18, f"every final bracket {width} wide; the last probe ({last.years} years) of members "
            f"0..{n - 1} equals their run alone bitwise (block build); a K={n} fold reproduces "
            f"{same} of those {n} members' decisions (reported, not held: a smaller ensemble "
            "stops its probes at other year counts)")
    out["fold"] = res
    return out


def phase19(dev, smi, fold):
    """``basins`` and ``edge`` at the same width, in the Classic bistable
    window found from phase 18's fold at the default D."""
    import energybalancemodel_jl_tpu_torch as ebt
    from energybalancemodel_jl_tpu_torch.fold import seasonal_ice_area
    from energybalancemodel_jl_tpu_torch.ops.classic_year import classic_year

    basins_mod = sys.modules["energybalancemodel_jl_tpu_torch.basins"]
    st = ebt.SpaceTime.sin(*CANONICAL, 1)
    nx = CANONICAL[0]
    par = ebt.default_parameters("Classic")
    i_def = int(np.argmin(np.abs(fold.par["D"] - par["D"])))
    F_warm = float(fold.values[i_def])  # where the warm branch ends at the default D
    # the window: levels above F_warm where a warm (E=40) and a cold
    # (E=-300) state settle more than jump_tol apart, both converged
    Fs = F_warm + np.linspace(0.0, BISTABLE_SPAN, BISTABLE_SCAN)
    E_w, E_c = np.full(nx, 40.0), np.full(nx, -300.0)
    pair = ebt.stack_states([{"E": E, "Tg": E / par["cw"]} for E in (E_w, E_c)])
    inits = {k: np.repeat(v, BISTABLE_SCAN, axis=0) for k, v in pair.items()}
    scan = ebt.equilibrate("Classic", st, 0.0, ebt.Collection(par, F=np.tile(Fs, 2)), inits,
                           tol=EQ_TOL_CLASSIC, max_years=2 * EQ_MAX_YEARS, dtype="float32",
                           device=dev)
    area = seasonal_ice_area(scan.seasonal.avg, st).reshape(2, BISTABLE_SCAN)
    conv = np.asarray(scan.converged).reshape(2, BISTABLE_SCAN).all(0)
    bistable = conv & (np.abs(area[0] - area[1]) > np.pi / 2)
    if bistable.sum() < 4:
        fail(f"phase 19: no bistable window above F={F_warm:.3f}: ice areas warm "
             f"{area[0].round(2).tolist()} cold {area[1].round(2).tolist()}")
    idx = np.flatnonzero(bistable)
    i_mid = int(idx[len(idx) // 2])
    F_mid = float(Fs[i_mid])
    settled = [ebt.Collection({k: np.asarray(v)[j] for k, v in scan.state.items()})
               for j in (i_mid, BISTABLE_SCAN + i_mid)]
    say(19, f"the Classic bistable window at D={par['D']}: F in [{Fs[idx[0]]:.4f}, "
            f"{Fs[idx[-1]]:.4f}] ({len(idx)} of {BISTABLE_SCAN} levels above phase 18's fold "
            f"F={F_warm:.4f}; {scan.years} years); at F={F_mid:.4f} the warm and the cold state "
            f"settle at ice areas {area[0, i_mid]:.4f} and {area[1, i_mid]:.4f} (jump_tol pi/2)")

    # -- basins of 8192 blends between the two settled states ----------------
    w = np.linspace(0.0, 1.0, K_MAIN)
    mapped, wall, launches, kern_s = _timed_run(
        lambda: ebt.basins("Classic", st, par, ebt.blend_states(*settled, w), forcing=F_mid,
                           tol=EQ_TOL_CLASSIC, max_years=EQ_MAX_YEARS, dtype="float32",
                           device=dev),
        classic_year, "classic_")
    r = mapped.result
    if launches != r.years:
        fail(f"basins: {launches} classic_year launches for {r.years} years")
    ok = np.asarray(r.converged) & basins_mod._finite_members(r, K_MAIN)
    if np.any(mapped.labels[ok] < 0) or mapped.n_basins != 2:
        fail(f"basins: {mapped!r}, the converged members not all labelled into two attractors")
    switch = int(np.flatnonzero((mapped.labels >= 0) & (mapped.labels != mapped.labels[0]))[0])
    for i in (0, switch, K_MAIN - 1):
        solo = ebt.equilibrate("Classic", st, F_mid, par, ebt.blend_states(*settled, w[i]),
                               tol=0.0, max_years=r.years, dtype="float32", device=dev)
        one = ebt.Collection({k: np.asarray(v)[i] for k, v in r.state.items()})
        if not all(np.array_equal(solo.state[k], one[k]) for k in one):
            fail(f"basins: member {i} differs from its run alone over {r.years} years")
    out = dict(basins_launches=launches, basins_kernel_ms_per_year=(
        kern_s / r.years * 1e3 if kern_s is not None else None))
    say(19, json.dumps(dict(
        path=f"basins('Classic', SpaceTime.sin(180, 2000, 1), F={F_mid:.4f}, 8192 blends of "
             "the settled warm and cold states)", K=K_MAIN, dtype="float32",
        tol=EQ_TOL_CLASSIC, max_years=EQ_MAX_YEARS, years=r.years,
        converged=int(np.count_nonzero(ok)), centroids=mapped.centroids.tolist(),
        counts=mapped.counts.tolist(), switch_member=switch, switch_w=float(w[switch]),
        classic_year_launches=launches, wall_s=wall,
        member_years_per_day=K_MAIN * r.years / wall * 86400.0,
        kernel_share=kern_s / wall if kern_s is not None else None, gpu=smi)))
    say(19, f"basins: members 0, {switch} (the first of the other attractor) and {K_MAIN - 1} "
            f"equal their runs alone bitwise over {r.years} years")

    # -- edge with the forcing swept across the window ------------------------
    inner = idx[len(idx) // 10: len(idx) - len(idx) // 10]
    F_edge = np.linspace(Fs[inner[0]], Fs[inner[-1]], K_MAIN)
    near = np.abs(F_edge[:, None] - Fs[None, inner]).argmin(1)  # nearest scanned level
    ends = [{k: np.asarray(v)[off + inner[near]] for k, v in scan.state.items()}
            for off in (0, BISTABLE_SCAN)]
    with _SolveLog(basins_mod) as log:
        tracked, wall, launches, kern_s = _timed_run(
            lambda: ebt.edge("Classic", st, ebt.Collection(par, F=F_edge), *ends, forcing=0.0,
                             steps=FOLD_STEPS, tol=EQ_TOL_CLASSIC, max_years=EDGE_MAX_YEARS,
                             dtype="float32", device=dev),
            classic_year, "classic_")
    if launches != sum(log.years):
        fail(f"edge: {launches} classic_year launches for {sum(log.years)} years")
    if not np.array_equal(tracked.width, np.full(K_MAIN, 2.0 ** -FOLD_STEPS)):
        fail(f"edge: final brackets {np.unique(tracked.width)} wide")
    out.update(edge_launches=launches, edge_kernel_ms_per_year=(
        kern_s / sum(log.years) * 1e3 if kern_s is not None else None))
    say(19, json.dumps(dict(
        path=f"edge('Classic', SpaceTime.sin(180, 2000, 1), F swept over [{F_edge[0]:.4f}, "
             f"{F_edge[-1]:.4f}], the settled states of the nearest scanned level)",
        K=K_MAIN, dtype="float32", steps=FOLD_STEPS, tol=EQ_TOL_CLASSIC,
        max_years=EDGE_MAX_YEARS, solve_years=log.years, classic_year_launches=launches,
        wall_s=wall, member_years_per_day=K_MAIN * sum(log.years) / wall * 86400.0,
        kernel_share=kern_s / wall if kern_s is not None else None,
        probe_finite=int(tracked.probe_finite.sum()),
        probe_converged=int(tracked.probe_converged.sum()), probes=tracked.in_a.size,
        w_star_min_max=[float(tracked.values.min()), float(tracked.values.max())], gpu=smi)))
    return out


# phase 20: the solo and eager drivers at diagnostic grids. The dense
# polish refuses grids past basins._POLISH_UNIT_CAP, and the eager year is
# launch-bound on the card (PERF.md §5), so these run at the JAX package's
# own measured configurations, each job in a process of its own
SEARCH_ST = (8, 1000)          # Classic, F=10: the JAX package's saddle
SADDLE_GUESS = dict(E=[93.6, 72.2, 18.8, -5.9, -15.2, -38.6, -58.5, -75.0],
                    Tg=[8.86, 6.67, 1.29, -12.1, -25.7, -38.8, -50.7, -61.3])
LYA_MIZ = (24, 400, 64, 16)    # nx, nt, K, member_chunk
BAR_LYA_STAB, BAR_LYA_CPU = 1e-6, 1e-10
SEARCH_TASKS = ("edge_state", "unstable_branch", "lyapunov icefree", "lyapunov miz cuda",
                "lyapunov miz cpu")


def _attractors(ebt, st, par, dev):
    """The warm and the snowball attractor of the Classic saddle's
    configuration (F=10, f64): states and ice areas."""
    from energybalancemodel_jl_tpu_torch.fold import seasonal_ice_area

    pair = ebt.stack_states([{"E": np.full(st.nx, E), "Tg": np.full(st.nx, E) / par["cw"]}
                             for E in (40.0, -300.0)])
    res = ebt.equilibrate("Classic", st, 10.0, par, pair, tol=0.5, max_years=300,
                          dtype="float64", device=dev)
    areas = seasonal_ice_area(res.seasonal.avg, st)
    return [ebt.Collection({k: v[i] for k, v in res.state.items()}) for i in (0, 1)], areas


def _search_task(task, miz_init):
    """One job of phase 20, in a process of its own. Returns a dict, with
    ``"error"`` when a hold failed."""
    import torch

    import energybalancemodel_jl_tpu_torch as ebt
    from energybalancemodel_jl_tpu_torch.basins import _residual_fns

    torch.set_num_threads(1)
    dev = torch.device("cpu") if task.endswith("cpu") else torch.device("cuda", 0)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    st = ebt.SpaceTime.sin(*SEARCH_ST, 1)
    par = ebt.default_parameters("Classic")
    out = {}
    if task == "edge_state":
        (a, b), areas = _attractors(ebt, st, par, dev)
        guess = ebt.Collection({k: np.asarray(v) for k, v in SADDLE_GUESS.items()})
        r = ebt.edge_state("Classic", st, par, ebt.blend_states(guess, a, 0.05),
                           ebt.blend_states(guess, b, 0.05), forcing=10.0,
                           refs=tuple(areas), stages=2, commit_years=200, commit_tol=0.5,
                           polish_max_nfev=10, dtype="float64", device=dev,
                           stability_kwargs=dict(n_iter=2, dtype="float64"))
        x0, _, jac, _, _ = _residual_fns("Classic", st, ebt.Forcing(10.0), par, r.state,
                                         torch.float64, dev)
        lam = np.sort(np.abs(np.linalg.eigvals(jac(x0) + np.eye(x0.size))))[::-1]
        out = dict(area=r.area, resid=r.resid, converged=r.converged, nfev=r.polish_nfev,
                   attractor_areas=areas.tolist(), stability_growth=r.stability.growth,
                   dense_spectrum=lam[:3].tolist(), stages=r.stages_run,
                   tracked_years=r.tracked_years.tolist())
        lo, hi = sorted(areas)
        if not (r.converged and lo + 0.3 < r.area < hi - 0.3 and lam[0] > 1.0 > lam[1]):
            out["error"] = (f"edge_state: {r!r}, areas {areas}, the dense spectrum's moduli "
                            f"{lam[:3]}: not one saddle with exactly one |lambda| > 1")
    elif task == "unstable_branch":
        (_, _), areas = _attractors(ebt, st, par, dev)
        br = ebt.unstable_branch("Classic", st, [10.0, 10.5], par,
                                 {k: np.asarray(v) for k, v in SADDLE_GUESS.items()},
                                 vary="F", forcing=0.0, polish_max_nfev=4, dtype="float64",
                                 device=dev)
        ice = np.asarray(br.ice_area()).reshape(-1)
        lo, hi = sorted(areas)
        out = dict(resid=[x.resid for x in br.results], nfev=br.years.tolist(),
                   converged=br.converged.tolist(), ice_area=ice.tolist(),
                   attractor_areas=areas.tolist())
        if not (br.converged.all() and np.all((lo + 0.3 < ice) & (ice < hi - 0.3))):
            out["error"] = f"unstable_branch: {br!r}, ice areas {ice}, attractors {areas}"
    elif task == "lyapunov icefree":
        E0 = np.full(st.nx, 100.0)
        eq = ebt.equilibrate("Classic", st, 45.0, par, {"E": E0, "Tg": E0 / par["cw"]},
                             tol=1e-9, max_years=400, dtype="float64", device=dev)
        # the year map is linear there: the dense Jacobian's leading
        # eigenvector is the right mode exactly
        x0, _, jac, from_mat, _ = _residual_fns("Classic", st, ebt.Forcing(45.0), par, eq.state,
                                                torch.float64, dev)
        lam, vec = np.linalg.eig(jac(x0) + np.eye(x0.size))
        i = int(np.argmax(np.abs(lam)))
        mode = from_mat(np.real(vec[:, i]))
        kw = dict(side="right", v0=mode, dtype="float64", device=dev)
        stab = ebt.stability("Classic", st, 45.0, par, eq.state, n_iter=2, **kw)
        kw.pop("side")
        # from the exact mode one year measures the exponent
        ly = ebt.lyapunov("Classic", st, 45.0, par, eq.state, years=1, **kw)
        out = dict(exponent=float(ly.exponents[0]), log_growth=float(np.log(stab.growth)),
                   log_dense=float(np.log(np.abs(lam[i]))), eq_years=eq.years,
                   history=ly.history[:, 0].tolist())
        if not (eq.converged and abs(out["exponent"] - out["log_growth"]) <= BAR_LYA_STAB):
            out["error"] = f"lyapunov at the ice-free equilibrium: {out}"
    else:  # lyapunov miz, on the card or on the CPU: the same run
        nx, nt, K, chunk = LYA_MIZ
        mpar = ebt.Collection(ebt.default_parameters("MIZ"), F=np.linspace(-5.0, 5.0, K))
        ly = ebt.lyapunov("MIZ", ebt.SpaceTime.sin(nx, nt, 1), 0.0, mpar, miz_init, years=1,
                          project=("Ew", "phi"), member_chunk=chunk, dtype="float64",
                          device=dev)
        out = dict(history=ly.history, state=ly.state)
    sync()
    out["wall_s"] = time.perf_counter() - t0
    return out


def search_init_state(dev):
    """Phase 20's MIZ state: 20 years of ``SpaceTime.sin(24, 400)`` from
    zeros, f64 (the MIZ ``lyapunov`` jobs start there)."""
    import energybalancemodel_jl_tpu_torch as ebt

    nx, nt, K, chunk = LYA_MIZ
    st = ebt.SpaceTime.sin(nx, nt, 20)
    sol = ebt.integrate("MIZ", st, ebt.Forcing(0.0), ebt.default_parameters("MIZ"),
                        ebt.zeros_init(st), dtype="float64", device=dev, progress=False)
    return {k: np.array(sol.raw[k][-1]) for k in ("Ei", "Ew", "h", "D", "phi")}


def search_phases(dev, smi, jobs=None):
    """Phases 18-20. ``jobs``: phase 20's results, where its jobs ran in
    phase 17's pool (the script's way); without them phase 20's CPU job runs
    beside phases 18-19 (it does not touch the card) and its card jobs beside
    each other after them, so that phases 18-19 time their kernels alone.
    Returns the year kernel's launches and times for the kernel table."""
    import multiprocessing

    nx, nt, K, chunk = LYA_MIZ
    t0 = time.perf_counter()
    if jobs is not None:
        out = phase18(dev, smi)
        out.update(phase19(dev, smi, out.pop("fold")))
        t20, results = time.perf_counter(), jobs
    else:
        miz_init = search_init_state(dev)
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(len(SEARCH_TASKS)) as pool:
            cpu_job = pool.apply_async(_search_task, ("lyapunov miz cpu", miz_init))
            out = phase18(dev, smi)
            out.update(phase19(dev, smi, out.pop("fold")))
            t20 = time.perf_counter()
            card = pool.starmap_async(_search_task, [(t, miz_init) for t in SEARCH_TASKS[:-1]])
            results = dict(zip(SEARCH_TASKS[:-1], card.get()))
            results["lyapunov miz cpu"] = cpu_job.get()
    for task, r in results.items():
        if "error" in r:
            fail(f"phase 20 {task}: {r['error']}")
    e, u, i = results["edge_state"], results["unstable_branch"], results["lyapunov icefree"]
    say(20, json.dumps(dict(
        path="edge_state('Classic', SpaceTime.sin(8, 1000), F=10, f64) near the known saddle",
        **{k: v for k, v in e.items()}, gpu=smi)))
    say(20, json.dumps(dict(
        path="unstable_branch('Classic', SpaceTime.sin(8, 1000), F in [10, 10.5, 11], f64)",
        **u, gpu=smi)))
    say(20, f"lyapunov('Classic', SpaceTime.sin(8, 1000), F=45, f64) at the ice-free "
            f"equilibrium ({i['eq_years']} years), from the dense Jacobian's leading mode: "
            f"exponent {i['exponent']:.12f}, stability's log growth {i['log_growth']:.12f} "
            f"(bar {BAR_LYA_STAB}), the dense eigenvalue's {i['log_dense']:.12f}; "
            f"{i['wall_s']:.1f} s")
    a, b = results["lyapunov miz cuda"], results["lyapunov miz cpu"]
    worst = float(np.max(np.abs(a["history"] - b["history"])))
    if not (np.isfinite(a["history"]).all() and worst <= BAR_LYA_CPU):
        fail(f"phase 20 lyapunov MIZ: the card's history differs from the CPU's by {worst:.3e}")
    say(20, f"lyapunov('MIZ', SpaceTime.sin({nx}, {nt}), K={K}, member_chunk={chunk}, "
            f"project=('Ew', 'phi'), f64, 1 year) on the card equals the CPU's to {worst:.3e} "
            f"(bar {BAR_LYA_CPU}); card {a['wall_s']:.1f} s, CPU {b['wall_s']:.1f} s")
    where = ("in phase 17's pool" if jobs is not None
             else f"{time.perf_counter() - t20:.1f} s after phase 19")
    say(20, f"phases 18-20: {time.perf_counter() - t0:.1f} s wall (phase 20's jobs {where}: "
            + ", ".join(f"{t} {r['wall_s']:.1f} s" for t, r in results.items()) + ")")
    return out


# phase 21: checkpoints on the main paths. The MIZ ensemble and the Picard
# equilibrate at the main path's width, the Classic single run on the block
# build; each interrupted by a writer that raises once the chosen year is on
# disk, then resumed
CKPT_YEARS = 4  # the ensemble's years; interrupted after 2
CKPT_CLASSIC_YEARS = 3  # the Classic run's; interrupted after 1
CKPT_EQ_YEARS = 8  # equilibrate's max_years (tol 0: all of them); interrupted after 4


class _Interrupted(Exception):
    pass


def _checkpointed(mod, name, years_of, run, stop, phase=21):
    """Run ``run()`` with the checkpoint writer ``mod.name`` wrapped: each
    write's seconds and file size are logged, and once the write whose
    ``years_of(args)`` equals ``stop`` is on disk the run is interrupted
    (``stop=None``: never). Returns (the result, or None when interrupted;
    the log)."""
    import os

    orig, log = getattr(mod, name), []

    def write(*args):
        t0 = time.perf_counter()
        out = orig(*args)
        years = years_of(args)
        log.append((years, time.perf_counter() - t0, os.path.getsize(args[0])))
        if years == stop:
            raise _Interrupted
        return out

    setattr(mod, name, write)
    try:
        res = run()
    except _Interrupted:
        res = None
    finally:
        setattr(mod, name, orig)
    if stop is not None and res is not None:
        fail(f"phase {phase}: the run was not interrupted after year {stop}")
    return res, log


def _writes(log):
    return ", ".join(f"year {y}: {s:.3f} s {b / 2**20:.1f} MiB" for y, s, b in log)


def _same_tree(a, b, what, phase=21):
    """Bitwise equality of two (nested) results of numpy arrays, NaNs at the
    same places."""
    if isinstance(a, dict):
        if sorted(a) != sorted(b):
            fail(f"phase {phase} {what}: keys differ")
        for k in a:
            _same_tree(a[k], b[k], f"{what}.{k}", phase)
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{what}[{i}]", phase)
    elif not np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True):
        fail(f"phase {phase} {what}: the resumed run differs from the uninterrupted one")


def checkpoint_phase(dev, smi):
    """Phase 21. Returns the resumes' launches for the kernel table."""
    import os
    import tempfile

    import energybalancemodel_jl_tpu_torch as ebt
    from energybalancemodel_jl_tpu_torch import checkpoint as ckpt
    from energybalancemodel_jl_tpu_torch.utils.hdf5 import lite
    from energybalancemodel_jl_tpu_torch.ops.classic_year import classic_year
    from energybalancemodel_jl_tpu_torch.ops.miz_year import miz_year

    t_phase = time.perf_counter()
    say(21, "HDF5 files written and read by " + (
        "the port's numpy-only module (energybalancemodel_jl_tpu_torch/utils/hdf5.py): "
        "h5py is not installed here" if ckpt.h5py is lite else f"h5py {ckpt.h5py.__version__}"))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the MIZ ensemble, f32, fused, D swept, a checkpoint every year
        st = ebt.SpaceTime.sin(*CANONICAL, CKPT_YEARS)
        par = ebt.default_parameters("MIZ")
        par["D"] = np.linspace(0.55, 0.65, K_MAIN)

        def ens(path, **kw):
            return ebt.ensemble_integrate("MIZ", st, ebt.Forcing(0.0), par, ebt.zeros_init(st),
                                          engine="fused", dtype="float32", device=dev,
                                          checkpoint=path, progress=False, **kw)

        years_of = lambda args: args[2]
        ref_path, path = os.path.join(tmp, "ens_ref.h5"), os.path.join(tmp, "ens.h5")
        full, ref_log = _checkpointed(ckpt, "write_checkpoint", years_of,
                                      lambda: ens(ref_path, checkpoint_every=CKPT_YEARS), None)
        _, cut_log = _checkpointed(ckpt, "write_checkpoint", years_of,
                                   lambda: ens(path, checkpoint_every=1), 2)
        miz_year.launches = 0
        resumed, res_log = _checkpointed(ckpt, "write_checkpoint", years_of,
                                         lambda: ens(path, checkpoint_every=1, resume=True),
                                         None)
        ens_launches = miz_year.launches
        if ens_launches != CKPT_YEARS - 2:
            fail(f"phase 21 (a): the resume made {ens_launches} miz_year launches, "
                 f"expected {CKPT_YEARS - 2}")
        carry_ref, carry = ckpt.read_checkpoint(ref_path)[0], ckpt.read_checkpoint(path)[0]
        _same_tree(carry, carry_ref, "(a) final carry")
        if "T0" not in carry:
            fail("phase 21 (a): the checkpointed carry lacks the Newton warm start T0")
        _same_tree(tuple(resumed.seasonal), tuple(full.seasonal), "(a) seasonal")
        say(21, f"(a) ensemble_integrate MIZ K={K_MAIN} {st!r} f32 fused, D swept: "
                f"interrupted after year 2, resumed with {ens_launches} miz_year launches; "
                f"final carry ({', '.join(sorted(carry))}) and every seasonal store bitwise "
                f"the uninterrupted run's. Checkpoint writes (seconds, file size): "
                f"interrupted run {_writes(cut_log)}; resume {_writes(res_log)}; "
                f"uninterrupted run, one write {_writes(ref_log)}; {smi}")
        out["ens"] = dict(launches=ens_launches)

        # (b) the Classic single run, block build, a warming-cooling ramp
        cst = ebt.SpaceTime.sin(*CANONICAL, CKPT_CLASSIC_YEARS)
        cpar = ebt.default_parameters("Classic")
        E0 = np.full(cst.nx, 30.0)
        ramp = ebt.Forcing(0.0, 2.0, -2.0, (0, 0), (2.0, -2.0))

        def classic(path, **kw):
            return ebt.integrate("Classic", cst, ramp, cpar, {"E": E0, "Tg": E0 / cpar["cw"]},
                                 dtype="float32", device=dev, checkpoint=path, progress=False,
                                 **kw)

        cref, cpath = os.path.join(tmp, "classic_ref.h5"), os.path.join(tmp, "classic.h5")
        cfull, _ = _checkpointed(ckpt, "write_checkpoint", years_of,
                                 lambda: classic(cref, checkpoint_every=CKPT_CLASSIC_YEARS), None)
        _, ccut = _checkpointed(ckpt, "write_checkpoint", years_of, lambda: classic(cpath), 1)
        classic_year.launches = 0
        cres, cres_log = _checkpointed(ckpt, "write_checkpoint", years_of,
                                       lambda: classic(cpath, resume=True), None)
        classic_launches = classic_year.launches
        if classic_launches != CKPT_CLASSIC_YEARS - 1:
            fail(f"phase 21 (b): the resume made {classic_launches} classic_year launches, "
                 f"expected {CKPT_CLASSIC_YEARS - 1}")
        _same_tree(ckpt.read_checkpoint(cpath)[0], ckpt.read_checkpoint(cref)[0],
                   "(b) final carry")
        _same_tree(tuple(cres.seasonal), tuple(cfull.seasonal), "(b) seasonal")
        _same_tree(cres.raw, cfull.raw, "(b) raw")
        say(21, f"(b) integrate Classic K=1 {cst!r} f32 (block build), a warming-cooling "
                f"ramp: interrupted after year 1, resumed with {classic_launches} classic_year "
                f"launches; final carry, raw year and seasonal stores bitwise. Writes: "
                f"{_writes(ccut + cres_log)}")
        out["classic"] = dict(launches=classic_launches)

        # (c) equilibrate, Picard, F swept as phase 15, all CKPT_EQ_YEARS years
        est = ebt.SpaceTime.sin(*CANONICAL, 1)
        epar = ebt.default_parameters("MIZ")
        epar["F"] = np.linspace(-10.0, 10.0, K_MAIN)

        def equil(**kw):
            return ebt.equilibrate("MIZ", est, 0.0, epar, ebt.zeros_init(est), tol=0.0,
                                   max_years=CKPT_EQ_YEARS, dtype="float32", device=dev, **kw)

        efull = equil()
        epath = os.path.join(tmp, "eq.h5")
        eq_years = lambda args: args[3]
        _, ecut = _checkpointed(ckpt, "write_eq_checkpoint", eq_years,
                                lambda: equil(checkpoint=epath), CKPT_EQ_YEARS // 2)
        miz_year.launches = 0
        eres, eres_log = _checkpointed(ckpt, "write_eq_checkpoint", eq_years,
                                       lambda: equil(checkpoint=epath, resume=True), None)
        eq_launches = miz_year.launches
        if eq_launches != CKPT_EQ_YEARS // 2 or eres.years != CKPT_EQ_YEARS:
            fail(f"phase 21 (c): the resume made {eq_launches} miz_year launches to year "
                 f"{eres.years}, expected {CKPT_EQ_YEARS // 2} to {CKPT_EQ_YEARS}")
        for name in ("state", "seasonal", "resid", "member_years"):
            _same_tree(getattr(eres, name), getattr(efull, name), f"(c) {name}")
        say(21, f"(c) equilibrate MIZ K={K_MAIN} canonical f32 Picard, F swept over [-10, 10], "
                f"tol 0, max_years {CKPT_EQ_YEARS}: interrupted after year {CKPT_EQ_YEARS // 2}, "
                f"resumed with {eq_launches} miz_year launches; state, seasonal stores, "
                f"residuals and member years bitwise. Writes: {_writes(ecut + eres_log)}")
        out["eq"] = dict(launches=eq_launches)

        # (d) files and plots
        for name, obj in (("EnsembleSolutions", resumed), ("EquilibriumResult", eres)):
            fpath = os.path.join(tmp, f"{name}.h5")
            t0 = time.perf_counter()
            ebt.save(obj, fpath)
            back = ebt.load(fpath)
            dt = time.perf_counter() - t0
            if type(back).__name__ != name:
                fail(f"phase 21 (d): {name} loaded as {type(back).__name__}")
            fields = (("seasonal", "parameters") if name == "EnsembleSolutions"
                      else ("state", "seasonal", "resid", "member_years"))
            for field in fields:
                _same_tree(getattr(back, field), getattr(obj, field), f"(d) {name}.{field}")
            say(21, f"(d) save + load of {name}: every array bitwise; "
                    f"{os.path.getsize(fpath) / 2**20:.1f} MiB in {dt:.2f} s")
        try:
            import matplotlib
        except ImportError:
            say(21, "(d) plot_avg and plot_seasonal not drawn: matplotlib is not installed "
                    "here (tests/test_torch_plot.py holds every plot against the JAX "
                    "package's on the CPU)")
            say(21, f"phase 21: {time.perf_counter() - t_phase:.1f} s")
            return out
        matplotlib.use("Agg", force=True)
        sizes = []
        for fn in (ebt.plot_avg, ebt.plot_seasonal):
            png = os.path.join(tmp, f"{fn.__name__}.png")
            ebt.save(fn(cres), png)
            with open(png, "rb") as f:
                if f.read(8) != b"\x89PNG\r\n\x1a\n":
                    fail(f"phase 21 (d): {fn.__name__} wrote no PNG")
            sizes.append(f"{fn.__name__} {os.path.getsize(png)} bytes")
        import matplotlib.pyplot as plt

        plt.close("all")
        say(21, f"(d) {', '.join(sizes)} of (b)'s Solutions under Agg")
    say(21, f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    return out


def _held_plain_task(model, dtype, carry, par, f, cfg, kw, shape=CANONICAL, n_years=1,
                     raw_last=False):
    """One plain year (or ``n_years``) in a process of its own: ``model``'s
    plain version at ``SpaceTime.sin(*shape, 1)`` (numpy inputs: the carry,
    the forcing row, the keyword modes with their arrays), on the card; with
    ``raw_last`` the last year is raw-collected. Phases 7 and 12 hold their
    small-grid kernels against these, phase 14 its held members. Returns
    ``((carry, seasonal, rest), ms)``: the last year's results as numpy
    (``rest`` the raw steps, or the year-end OU value and the crossing
    steps, where the year has them) and the years' milliseconds on the host
    clock."""
    import torch

    import energybalancemodel_jl_tpu_torch as ebt
    from energybalancemodel_jl_tpu_torch.ops.classic_year import classic_year_reference
    from energybalancemodel_jl_tpu_torch.ops.miz_year import miz_year_reference

    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    t = lambda v: torch.as_tensor(v, dtype=getattr(torch, dtype), device=dev)
    args = {}
    for k, v in kw.items():
        if k == "noise_keys":
            args[k] = v
        elif k == "noise_ou":
            args[k] = (v[0], v[1], t(v[2]))
        elif k == "crossing":
            args[k] = tuple(t(x) for x in v)
        else:
            args[k] = t(v)
    plain = miz_year_reference if model == "MIZ" else classic_year_reference
    st = ebt.SpaceTime.sin(*shape, 1)
    carry = ebt.Collection({k: t(v) for k, v in carry.items()})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for y in range(n_years):
        out = plain(carry, par, t(f), st, cfg, collect_raw=raw_last and y == n_years - 1,
                    **args)
        carry = out[0]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    cpu = lambda c: {k: v.cpu().numpy() for k, v in c.items()}
    rest = [None if v is None else cpu(v) if isinstance(v, dict) else v.cpu().numpy()
            for v in out[3:]]
    return (cpu(out[0]), [cpu(c) for c in out[1]], rest), ms


def _plain_pool(tasks):
    """``_held_plain_task`` over ``tasks`` (argument tuples), at most eight
    at once, each in a spawned process of its own: the plain years are bound
    by the host's launches, one core each."""
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(min(len(tasks), 8)) as pool:
        return pool.starmap(_held_plain_task, tasks)


# -- phase 22: the high-resolution runs ---------------------------------------
# The wide builds (csrc/common.cuh) against their plain versions, bitwise,
# at the widths the JAX package fuses, then the main paths at high
# resolution. MIZ's explicit Tb diffusion needs D nx^2 / nt near the
# canonical grid's: its comparisons scale D so (a year of NaNs would compare
# trivially), and its high-resolution year scales nt
HR_CLASSIC_NX, HR_CLASSIC_NT = (8192, 32768), 1000
# the MIZ comparisons: at the main path's width (HR_MIZ_MAIN), at the width
# timed and given every noise mode, and at the widest
HR_MIZ_NX, HR_MIZ_NT = (1536, 2048, 16384), 64
HR_MIZ_TIMED = 2048
HR_NOISE_NT = 1000  # the Classic noise modes' year (at nt=200 its explicit E step diverges)
HR_K_OVER = 8  # members beyond the blocks that stay resident, at nx = 8192
HR_SYSTEMS = 64  # K11 and K10 systems
HR_BATCHED_NT = 16  # the batched engine's steps at the wide widths (K10, K11 main path)
# the MIZ high-resolution year: nx = 2048 / nt = 262144 takes 160 s on an
# H100 in float32, where the Newton solve meets its tolerance rarely and
# makes ~27 updates a step (tools/kernel_times.py highres, PERF.md), so the phase
# runs the shorter year at the same coupling
HR_MIZ_MAIN = (1536, 147456)
COUPLING = 180 ** 2 / 2000  # the canonical MIZ grid's nx^2 / nt


def _bitwise(a, b):
    import torch

    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


def _max_err(out_k, out_p, label):
    """Max |kernel - plain| over every tensor of two year results (carry,
    seasonal stores, raw steps, eta, crossing steps), failing unless they
    are bitwise equal, NaNs at the same places."""
    import torch

    def leaves(v, path):
        if v is None:
            return
        if torch.is_tensor(v):
            yield path, v
        elif isinstance(v, dict):
            for k in v:
                yield from leaves(v[k], f"{path}.{k}")
        else:
            for i, x in enumerate(v):
                yield from leaves(x, f"{path}[{i}]")

    worst = 0.0
    for (what, a), (_, b) in zip(leaves(tuple(out_k), label), leaves(tuple(out_p), label)):
        d = float((torch.nan_to_num(a) - torch.nan_to_num(b)).abs().max()) if a.numel() else 0.0
        worst = max(worst, d)
        if not _bitwise(a, b):
            fail(f"phase 22 {what}: kernel and plain version differ (max {d:.3e})")
    return worst


def _event_ms(fn, n):
    """ms per call by CUDA events over n launches after a warm-up."""
    from energybalancemodel_jl_tpu_torch.tools.kernel_times import event_ms

    fn()
    return event_ms(fn, n)


@contextlib.contextmanager
def _plain_newton_updates():
    """Counts the Newton updates of the plain MIZ year while open: the
    iterations of each of its lockstep solves (``models/miz.py``)."""
    from energybalancemodel_jl_tpu_torch.models import miz as tmiz

    count, inner = [0], tmiz._newton_root

    def counting(T0_warm, args, cfg):
        T0, converged, it = inner(T0_warm, args, cfg)
        count[0] += it
        return T0, converged, it

    tmiz._newton_root = counting
    try:
        yield count
    finally:
        tmiz._newton_root = inner


def _host_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def highres_phase(dev, smi):
    """Phase 22. Returns, per wide build, what the kernel table reports."""
    import os
    import tempfile

    import torch

    import energybalancemodel_jl_tpu_torch as ebt
    from energybalancemodel_jl_tpu_torch import checkpoint as ckpt
    from energybalancemodel_jl_tpu_torch.integrate import resolve_engine
    from energybalancemodel_jl_tpu_torch.models.base import (StepConfig, default_step_config,
                                                              dtype_name)
    from energybalancemodel_jl_tpu_torch.ops import _build, _year, prng
    from energybalancemodel_jl_tpu_torch.ops.classic_year import (classic_year,
                                                                   classic_year_reference)
    from energybalancemodel_jl_tpu_torch.ops.diffusion import diffusion_bands
    from energybalancemodel_jl_tpu_torch.ops.miz_year import (CARRY_KEYS, miz_year,
                                                               miz_year_reference)
    from energybalancemodel_jl_tpu_torch.ops.newton_t0 import newton_t0, newton_t0_reference
    from energybalancemodel_jl_tpu_torch.ops.pcr_fused import pcr_fused
    from energybalancemodel_jl_tpu_torch.ops.tridiag import pcr_solve, tridiag_matvec
    from energybalancemodel_jl_tpu_torch.tools.kernel_times import ptxas_rows

    t_phase = time.perf_counter()
    out = {}
    fixed2 = StepConfig(solver="pcr", newton_abstol=0.0, newton_reltol=0.0,
                        newton_max_step=50.0, newton_max_iter=2)
    # more members than the card has SMs: more than any cluster build keeps
    # resident (checked against each plan)
    resident = torch.cuda.get_device_properties(dev).multi_processor_count

    def classic_inputs(nx, nt, K, dtype):
        st = ebt.SpaceTime.sin(nx, nt, 1)
        par = ebt.default_parameters("Classic")
        if K > 1:
            par["D"] = np.linspace(0.55, 0.65, K)
        E = torch.full((K, nx), 30.0, dtype=dtype, device=dev)
        f = torch.as_tensor(np.random.default_rng(7).normal(0.0, 0.5, nt), dtype=dtype,
                            device=dev)
        return st, par, ebt.Collection(E=E, Tg=E / par["cw"]), f

    def miz_inputs(nx, nt, K, dtype):
        st = ebt.SpaceTime.sin(nx, nt, 1)
        par = ebt.default_parameters("MIZ")
        D = par["D"] * COUPLING * nt / nx ** 2
        par["D"] = np.linspace(D, 1.1 * D, K) if K > 1 else D
        carry = ebt.Collection(
            {k: torch.zeros((K, nx), dtype=dtype, device=dev) for k in CARRY_KEYS})
        return st, par, carry, torch.zeros(nt, dtype=dtype, device=dev)

    def raw_year(year, inputs, cfg):
        st, par, carry, f = inputs
        res = year(carry, par, f, st, cfg, collect_raw=True)
        torch.cuda.synchronize()
        return res

    # (a) Classic single runs, one raw-collected year, f32 and f64
    err, ms = {}, {}
    for nx in HR_CLASSIC_NX:
        for dtype in (torch.float32, torch.float64):
            inp = classic_inputs(nx, HR_CLASSIC_NT, 1, dtype)
            cfg = default_step_config(str(dtype).split(".")[1])
            k = raw_year(classic_year, inp, cfg)
            p, plain_ms = _host_ms(lambda: raw_year(classic_year_reference, inp, cfg))
            label = f"Classic {dtype} nx={nx}"
            err[label] = _max_err(k, p, label)
            if not bool(torch.isfinite(k[0]["E"]).all()):
                fail(f"phase 22 {label}: the carry is not finite")
            if nx == max(HR_CLASSIC_NX) and dtype == torch.float32:
                st, par, carry, f = inp
                ms["classic"] = _event_ms(lambda: classic_year(carry, par, f, st, cfg), 2)
                ms["classic_plain"] = plain_ms
            del k, p, inp
    # (b) K beyond the resident clusters, D swept: the clusters loop over
    # members (the plan takes the narrowest cluster, the most resident)
    K = resident + HR_K_OVER
    st, par, carry, f = classic_inputs(HR_CLASSIC_NX[0], HR_CLASSIC_NT, K, torch.float32)
    cfg = default_step_config("float32")
    over_plan = _year.cluster_plan("classic_year", st.nx, st.nt, K, torch.float32, dev)
    if K <= over_plan.clusters:
        fail(f"phase 22: K={K} members fit the {over_plan.clusters} resident clusters")
    ens = classic_year(carry, par, f, st, cfg)
    err[f"Classic K={K}"] = _max_err(ens, classic_year_reference(carry, par, f, st, cfg),
                                     f"Classic K={K} nx={HR_CLASSIC_NX[0]}")
    for m in (0, K // 2, K - 1):
        solo = classic_year(ebt.Collection({k: v[m:m + 1] for k, v in carry.items()}),
                            dict(par, D=par["D"][m]), f, st, cfg)
        if not (all(_bitwise(solo[0][k][0], ens[0][k][m]) for k in solo[0]) and all(
                _bitwise(a[k][0], b[k][m]) for a, b in zip(solo[1], ens[1]) for k in a)):
            fail(f"phase 22: Classic member {m} of K={K} differs from its solo run")
    del ens, carry
    say(22, f"Classic cluster build vs plain, bitwise: K=1 nt={HR_CLASSIC_NT} raw-collected at "
            f"nx {HR_CLASSIC_NX}, f32 and f64; K={K} (> the {over_plan.clusters} resident "
            f"clusters of C={over_plan.C}) D swept at nx={HR_CLASSIC_NX[0]}, members 0, "
            f"{K // 2}, {K - 1} bitwise their solo runs. "
            "max|kernel-plain|: " + ", ".join(f"{k} {v:.3e}" for k, v in err.items()))

    # (c) MIZ, 2 fixed Newton iterations, one raw-collected year, f32 and f64
    for nx in HR_MIZ_NX:
        for dtype in (torch.float32, torch.float64):
            inp = miz_inputs(nx, HR_MIZ_NT, 1, dtype)
            k = raw_year(miz_year, inp, fixed2)
            p, plain_ms = _host_ms(lambda: raw_year(miz_year_reference, inp, fixed2))
            label = f"MIZ {dtype} nx={nx}"
            err[label] = _max_err(k, p, label)
            if not all(bool(torch.isfinite(v).all()) for v in k[0].values()):
                fail(f"phase 22 {label}: the carry is not finite")
            if nx == HR_MIZ_TIMED and dtype == torch.float32:
                st, par, carry, f = inp
                ms["miz"] = _event_ms(lambda: miz_year(carry, par, f, st, fixed2), 3)
                ms["miz_plain"] = plain_ms
            del k, p, inp
    # the main path's Newton mode at its width: the default tolerances at
    # K=1, where the plain version's lockstep loop is the kernel's own, so
    # the two make the same updates (the block max of the residual decides
    # the kernel's) and round alike
    nx, updates = HR_MIZ_MAIN[0], {}
    for dtype in (torch.float32, torch.float64):
        st, par, carry, f = miz_inputs(nx, HR_MIZ_NT, 1, dtype)
        cfg = default_step_config(str(dtype).split(".")[1])
        counted = torch.zeros(1, dtype=torch.int32, device=dev)
        k = miz_year(carry, par, f, st, cfg, newton_iters=counted)
        with _plain_newton_updates() as plain_count:
            p = miz_year_reference(carry, par, f, st, cfg)
        label = f"MIZ adaptive {dtype} nx={nx}"
        err[label] = _max_err(k, p, label)
        updates[label] = int(counted.sum()), plain_count[0]
        if updates[label][0] != updates[label][1]:
            fail(f"phase 22 {label}: the kernel made {updates[label][0]} Newton updates in "
                 f"the year, the plain version {updates[label][1]}")
    # K beyond the resident clusters at the main path's width
    K = resident + HR_K_OVER
    st, par, carry, f = miz_inputs(nx, HR_MIZ_NT, K, torch.float32)
    over_plan = _year.cluster_plan("miz_year", nx, HR_MIZ_NT, K, torch.float32, dev)
    if K <= over_plan.clusters:
        fail(f"phase 22: K={K} members fit the {over_plan.clusters} resident clusters")
    ens = miz_year(carry, par, f, st, fixed2)
    err[f"MIZ K={K}"] = _max_err(ens, miz_year_reference(carry, par, f, st, fixed2),
                                 f"MIZ K={K} nx={nx}")
    for m in (0, K // 2, K - 1):
        solo = miz_year(ebt.Collection({k: v[m:m + 1] for k, v in carry.items()}),
                        dict(par, D=par["D"][m]), f, st, fixed2)
        if not (all(_bitwise(solo[0][k][0], ens[0][k][m]) for k in solo[0]) and all(
                _bitwise(a[k][0], b[k][m]) for a, b in zip(solo[1], ens[1]) for k in a)):
            fail(f"phase 22: MIZ member {m} of K={K} differs from its solo run")
    del ens, carry
    say(22, f"MIZ cluster build: K={K} (> the {over_plan.clusters} resident clusters of "
            f"C={over_plan.C}) D swept at nx={nx}, nt={HR_MIZ_NT}, 2 fixed Newton iterations, "
            f"bitwise the plain version, members 0, {K // 2}, {K - 1} bitwise their solo runs")
    say(22, f"MIZ cluster build vs plain, bitwise: K=1 nt={HR_MIZ_NT}, D scaled to the canonical "
            f"D nx^2/nt, 2 fixed Newton iterations, raw-collected, at nx {HR_MIZ_NX}, f32 and "
            f"f64; the default Newton tolerances at nx={nx}, f32 and f64, Newton updates "
            f"(kernel, plain) "
            + ", ".join(f"{k.split()[2]} {v}" for k, v in updates.items()) + ": "
            + ", ".join(f"{k} {v:.3e}" for k, v in err.items() if k.startswith("MIZ")))

    # (d) every noise mode once, f32, K=2. The Classic plain year is long
    # (nt=1000), so its four modes without a crossing share one: its eight
    # members take each mode's per-step offsets (noise_offsets, as the plain
    # version computes them) as a noise table, and each member of a plain
    # year is its run alone (no operation mixes members)
    OU = (0.95, 3.0, 0.5)
    noise_err = {}
    for model, year, plain, mk, nx, nt, cfg in (
            ("Classic", classic_year, classic_year_reference, classic_inputs,
             HR_CLASSIC_NX[0], HR_NOISE_NT, default_step_config("float32")),
            ("MIZ", miz_year, miz_year_reference, miz_inputs, HR_MIZ_TIMED, HR_MIZ_NT, fixed2)):
        st, par, carry, f = mk(nx, nt, 2, torch.float32)
        keys = prng.member_year_keys(5, 2, 2)
        table = torch.as_tensor(np.random.default_rng(3).normal(size=(nt, 2)),
                                dtype=torch.float32, device=dev)
        thr = float(np.sum(np.diff(st.x))) * 0.3
        modes = {"table": dict(noise=table), "table/OU": dict(noise=table, noise_ou=OU),
                 "keys/serial": dict(noise_keys=keys, noise_ou=OU),
                 "keys/assoc": dict(noise_keys=keys, noise_ou=OU, ou_assoc=True),
                 "keys/crossing": dict(noise_keys=keys, noise_ou=OU, crossing=(thr, 1.0))}
        shared = [m for m in modes if model == "Classic" and "crossing" not in modes[m]]
        if shared:
            paths = [_year.noise_offsets(
                modes[m].get("noise"), modes[m].get("noise_ou"), modes[m].get("noise_keys"),
                modes[m].get("ou_assoc", False), 2, nt, torch.float32, dev,
                unroll=_year.classic_ou_unroll(nt)) for m in shared]
            n = 2 * len(shared)
            both = plain(ebt.Collection({k: v.repeat(len(shared), 1) for k, v in carry.items()}),
                         dict(par, D=np.tile(par["D"], len(shared))), f, st, cfg,
                         noise=torch.cat([off for off, _ in paths], dim=1))
            if both[0]["E"].shape != (n, nx):
                fail(f"phase 22: the shared plain year has {both[0]['E'].shape} members")
        for mode, kw in modes.items():
            label = f"{model} nx={nx} {mode}"
            k = year(carry, par, f, st, cfg, **kw)
            if mode in shared:
                j = 2 * shared.index(mode)
                cut = lambda c: {name: v[j:j + 2] for name, v in c.items()}
                noise_err[label] = _max_err(
                    (k[0], tuple(k[1]), k[3]),
                    (cut(both[0]), tuple(cut(s) for s in both[1]),
                     paths[shared.index(mode)][1]), label)
                if (k[3] is None) != ("noise_ou" not in kw):
                    fail(f"phase 22 {label}: the year-end OU value is missing or extra")
            else:
                noise_err[label] = _max_err(k, plain(carry, par, f, st, cfg, **kw), label)
            if not all(bool(torch.isfinite(v).all()) for v in k[0].values()):
                fail(f"phase 22 {label}: the carry is not finite")
    say(22, f"noise modes on the wide builds vs plain, bitwise (K=2 f32; Classic "
            f"nt={HR_NOISE_NT}, its four modes without a crossing against members of one plain "
            f"year; MIZ nt={HR_MIZ_NT} with 2 fixed Newton iterations; eta and crossing steps "
            "included; every carry finite): "
            + ", ".join(f"{k} {v:.3e}" for k, v in noise_err.items()))

    # (e) K11 and K10 on their cluster builds, f32 and f64: bitwise one plain
    # result each, at every C whose plan launches and at the C the C side
    # chooses (C=0), with more systems than clusters resident
    rng = np.random.default_rng(22)
    n11 = max(HR_CLASSIC_NX)
    k_err, resid, k_plans = {}, {}, {}

    def each_c(kernel, n, K, dtype, run, want, label):
        """``run()`` at every C (0: the C side's choice), each bitwise
        ``want``; the plans, and which C do not fit, recorded."""
        for C in (0, 2, 4, 8, 16):
            _year.FORCE_CLUSTER[kernel] = C
            try:
                plan = _year.cluster_plan(kernel, n, 1, K, dtype, dev)
            except RuntimeError:
                if C == 0:
                    fail(f"phase 22 {label}: no plan launches")
                k_plans[f"{label} C={C}"] = "does not fit"
                continue
            finally:
                _year.FORCE_CLUSTER[kernel] = 0
            _year.FORCE_CLUSTER[kernel] = C
            try:
                got = run()
            finally:
                _year.FORCE_CLUSTER[kernel] = 0
            key = f"{label} C={C or 'chosen'}"
            k_err[key] = _max_err((got,), (want,), key)
            k_plans[key] = dict(plan._asdict(), over=K > plan.clusters)
            if C == 0 and K <= plan.clusters:
                fail(f"phase 22 {label}: K={K} systems fit the {plan.clusters} resident clusters")

    for dtype in (torch.float32, torch.float64):
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        lo, up = rng.normal(size=(HR_SYSTEMS, n11)), rng.normal(size=(HR_SYSTEMS, n11))
        di = (np.abs(lo) + np.abs(up) + rng.uniform(0.5, 2.0, lo.shape)) * rng.choice(
            [-1.0, 1.0], lo.shape)
        lo[:, 0] = up[:, -1] = 0.0
        b = t(rng.normal(size=(HR_SYSTEMS, n11)))
        for bands, kind in (((t(lo), t(di), t(up)), "per-system"),
                            ((t(lo[0]), t(di[0]), t(up[0])), "shared")):
            want = pcr_solve(*bands, b)
            each_c("pcr_fused", n11, HR_SYSTEMS, dtype, lambda: pcr_fused(*bands, b), want,
                   f"K11 {dtype_name(dtype)} {kind}")
            x = pcr_fused(*bands, b)
            r = tridiag_matvec(*(v.double() for v in bands), x.double()) - b.double()
            resid[f"K11 {dtype} {kind}"] = float(r.norm() / b.double().norm())
        if dtype == torch.float32:
            bands = (t(lo), t(di), t(up))
            ms["pcr"] = _event_ms(lambda: pcr_fused(*bands, b), 10)
            ms["pcr_plain"] = _host_ms(lambda: pcr_solve(*bands, b))[1]
    n10 = max(HR_MIZ_NX)
    mpar = ebt.default_parameters("MIZ")
    st10 = ebt.SpaceTime.sin(n10, 1000, 1)
    geom = diffusion_bands(st10)
    insol = (mpar["S0"] - mpar["S1"] * st10.x * np.cos(2 * np.pi * 0.3)) - mpar["S2"] * st10.x ** 2
    for dtype in (torch.float32, torch.float64):
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        g = np.random.default_rng(12)
        shape = (HR_SYSTEMS, n10)
        args = [t(g.normal(-5.0, 5.0, shape)), t(np.abs(g.normal(1.0, 0.5, shape)) + mpar["hmin"]),
                t(g.normal(0.0, 3.0, shape)), t(g.uniform(0.0, 1.0, shape)),
                t(np.tile(insol, (HR_SYSTEMS, 1))), t(geom.lo), t(geom.di), t(geom.up),
                t(np.linspace(0.55, 0.65, HR_SYSTEMS) * COUPLING * 2000 / n10 ** 2), mpar["k"],
                mpar["Tm"], mpar["A"], mpar["B"], mpar["ai"], 0.0]
        want = newton_t0_reference(*args, max_step=50.0, iters=6)
        each_c("newton_t0", n10, HR_SYSTEMS, dtype,
               lambda: newton_t0(*args, max_step=50.0, iters=6), want, f"K10 {dtype_name(dtype)}")
        if not bool(torch.isfinite(want).all()):
            fail(f"phase 22 K10 {dtype}: not finite")
        if dtype == torch.float32:
            ms["newton"] = _event_ms(lambda: newton_t0(*args, max_step=50.0, iters=6), 5)
            ms["newton_plain"] = _host_ms(lambda: newton_t0_reference(*args, max_step=50.0,
                                                                      iters=6))[1]
    say(22, f"K11 at ({HR_SYSTEMS}, {n11}) and K10 at ({HR_SYSTEMS}, {n10}) (6 iterations) on "
            "their cluster builds vs one plain result each, bitwise, at every C that fits: "
            + ", ".join(f"{k} {v:.3e}" for k, v in k_err.items())
            + "; K11 |A x - b| / |b| (tridiag_matvec, in float64): "
            + ", ".join(f"{k} {v:.3e}" for k, v in resid.items()))
    regs = ptxas_rows(_build.build_log())
    for key, p in k_plans.items():
        if isinstance(p, dict):
            short = "f32" if "float32" in key else "f64"
            p["registers"] = regs.get(f"{'pcr' if key.startswith('K11') else 'newton_t0'}"
                                      f"_cluster_kernel<{short}>")
    say(22, "K11 and K10 cluster plans (C, threads, records in shared memory, resident "
            "clusters, shared bytes per block, more systems than resident clusters, "
            "registers): " + "; ".join(
                f"{k}: " + (v if isinstance(v, str) else
                            f"C={v['C']} threads={v['threads']} "
                            f"records_shared={v['records_shared']} clusters={v['clusters']} "
                            f"shared={v['shared_bytes']} B over={v['over']} {v['registers']}")
                for k, v in k_plans.items()))
    out["k_plans"] = k_plans

    # the cluster builds as the C side planned them for this phase's calls:
    # C, threads, shared bytes per block, resident clusters, registers
    regs = ptxas_rows(_build.build_log())
    plans = {}
    for kernel, nx_, nt_, K_, noisy, count in (
            ("classic_year", HR_CLASSIC_NX[0], HR_CLASSIC_NT, 1, False, False),
            ("classic_year", HR_CLASSIC_NX[1], HR_CLASSIC_NT, 1, False, False),
            ("classic_year", HR_CLASSIC_NX[0], HR_NOISE_NT, 2, True, False),
            ("classic_year", HR_CLASSIC_NX[0], HR_CLASSIC_NT, resident + HR_K_OVER, False, False),
            ("miz_year", HR_MIZ_MAIN[0], HR_MIZ_MAIN[1], 1, False, False),
            ("miz_year", HR_MIZ_MAIN[0], HR_MIZ_NT, 1, False, True),
            ("miz_year", HR_MIZ_TIMED, HR_MIZ_NT, 2, True, False),
            ("miz_year", max(HR_MIZ_NX), HR_MIZ_NT, 1, False, False),
            ("miz_year", HR_MIZ_MAIN[0], HR_MIZ_NT, resident + HR_K_OVER, False, False)):
        for dtype in (torch.float32, torch.float64):
            p = _year.cluster_plan(kernel, nx_, nt_, K_, dtype, dev, noisy, 1 if noisy else 0,
                                   count)
            flags = f"{int(noisy)}" + (f",{int(count)}" if kernel == "miz_year" else "")
            short = "f32" if dtype == torch.float32 else "f64"
            build = f"{kernel.split('_')[0]}_cluster_kernel<{short},{flags}>"
            plans[f"{kernel} nx={nx_} K={K_} {dtype_name(dtype)}{' noisy' if noisy else ''}"
                  f"{' count' if count else ''}"] = dict(p._asdict(), registers=regs.get(build))
    say(22, "cluster builds as planned (C, threads, records in shared memory, resident "
            "clusters, shared bytes per block, registers): " + "; ".join(
                f"{k}: C={v['C']} threads={v['threads']} records_shared={v['records_shared']} "
                f"clusters={v['clusters']} shared={v['shared_bytes']} B {v['registers']}"
                for k, v in plans.items()))
    out["plans"] = plans

    # (f) the main paths at high resolution
    with tempfile.TemporaryDirectory() as tmp:
        nx = max(HR_CLASSIC_NX)
        st = ebt.SpaceTime.sin(nx, HR_CLASSIC_NT, 2)
        if resolve_engine("Classic", st, dev) != "fused":
            fail(f"phase 22: engine='auto' does not resolve to the fused engine at nx={nx}")
        ramp = ebt.Forcing(0.0, 1.0, 0.0, (0, 0), (1.0, -1.0))
        cpar = ebt.default_parameters("Classic")
        E0 = np.full(nx, 30.0)

        def run(path, **kw):
            return ebt.integrate("Classic", st, ramp, cpar, {"E": E0, "Tg": E0 / cpar["cw"]},
                                 device=dev, progress=False, raw_mode="none", engine="auto",
                                 checkpoint=path, **kw)

        years_of = lambda args: args[2]
        ref, cut = os.path.join(tmp, "full.h5"), os.path.join(tmp, "cut.h5")
        classic_year.launches = 0
        t0 = time.perf_counter()
        full, _ = _checkpointed(ckpt, "write_checkpoint", years_of, lambda: run(ref), None, 22)
        full_s = time.perf_counter() - t0
        full_launches = classic_year.launches
        _checkpointed(ckpt, "write_checkpoint", years_of, lambda: run(cut), 1, 22)
        classic_year.launches = 0
        resumed, _ = _checkpointed(ckpt, "write_checkpoint", years_of,
                                   lambda: run(cut, resume=True), None, 22)
        resume_launches = classic_year.launches
        if (full_launches, resume_launches) != (2, 1):
            fail(f"phase 22: the Classic run made {full_launches} + {resume_launches} "
                 "classic_year launches, expected 2 + 1")
        _same_tree(tuple(resumed.seasonal), tuple(full.seasonal), "Classic seasonal", 22)
        _same_tree(ckpt.read_checkpoint(cut)[0], ckpt.read_checkpoint(ref)[0], "Classic carry",
                   22)
        if not np.isfinite(full.seasonal.avg["E"]).all():
            fail("phase 22: the Classic high-resolution run is not finite")
        out["classic"] = dict(launches=full_launches + resume_launches,
                              s_per_year=full_s / st.dur)
        say(22, f"integrate('Classic', {st!r}, {ramp!r}, engine='auto', checkpoint=...) f32: "
                f"{full_s / st.dur:.3f} s per year, {full_launches} classic_year launches; "
                f"interrupted after year 1 and resumed with {resume_launches} launch, every "
                f"seasonal store and the final carry bitwise the uninterrupted run's; {smi}")

    nx, nt = HR_MIZ_MAIN
    st = ebt.SpaceTime.sin(nx, nt, 1)
    miz_year.launches = 0
    t0 = time.perf_counter()
    sol = ebt.integrate("MIZ", st, ebt.Forcing(0.0), ebt.default_parameters("MIZ"),
                        ebt.zeros_init(st), dtype="float32", device=dev, progress=False,
                        raw_mode="none", engine="auto")
    secs = time.perf_counter() - t0
    finite = all(np.isfinite(store[k]).all() for store in sol.seasonal
                 for k in ("E", "T", "h", "Ei", "Ew", "D", "phi", "n"))
    if miz_year.launches != 1 or not finite:
        fail(f"phase 22: MIZ {st!r}: {miz_year.launches} miz_year launches, finite={finite}")
    out["miz"] = dict(launches=miz_year.launches, s_per_year=secs, shape=f"{st!r} float32")
    say(22, f"integrate('MIZ', {st!r}, Forcing(0.0), engine='auto', raw_mode='none') f32: "
            f"{secs:.3f} s for the year ({secs / nt * 1e6:.2f} us per step), 1 miz_year launch, "
            f"every seasonal store finite (nx^2/nt = {nx ** 2 / nt:.2f}); {smi}")

    # the batched engine at the wide widths: K11 under Classic's implicit
    # step, K10 under MIZ's T0 solve
    for model, solver, counter, nx in (("Classic", "pcr_fused", pcr_fused, n11),
                                       ("MIZ", "pallas", newton_t0, n10)):
        st = ebt.SpaceTime.sin(nx, HR_BATCHED_NT, 1)
        par = ebt.default_parameters(model)
        if model == "MIZ":
            par["D"] = par["D"] * COUPLING * HR_BATCHED_NT / nx ** 2 * np.array([1.0, 1.1])
            init = ebt.zeros_init(st)
        else:
            par["D"] = np.array([0.55, 0.65])
            init = {"E": np.full(nx, 30.0), "Tg": np.full(nx, 30.0) / par["cw"]}
        counter.launches = 0
        res, batched_ms = _host_ms(lambda: ebt.ensemble_integrate(
            model, st, ebt.Forcing(0.0), par, init, engine="batched", solver=solver,
            dtype="float32", device=dev, progress=False))
        finite = bool(np.isfinite(res.seasonal.avg["E"]).all())
        if counter.launches <= 0 or not finite:
            fail(f"phase 22: batched {model} solver={solver!r} at nx={nx}: "
                 f"{counter.launches} launches, finite={finite}")
        out[counter.__name__] = dict(launches=counter.launches, ms=batched_ms)
        say(22, f"ensemble_integrate('{model}', engine='batched', solver={solver!r}) K=2 "
                f"{st!r} f32: {batched_ms / 1e3:.3f} s, {counter.__name__} launches "
                f"+{counter.launches}, finite")

    out.update(err=err, noise_err=noise_err, k_err=k_err, resid=resid, ms=ms, resident=resident)
    say(22, f"phase 22: {time.perf_counter() - t_phase:.1f} s")
    return out


# -- phase 23: the multi-device layer (M14) on one card ------------------------
# A mesh of MESH_SHARDS shards on cuda:0 (a device repeated: each shard a
# thread of its own with a CUDA stream of its own). The member-sharded paths
# run at the main path's shape and are bitwise their unsharded runs (members
# equal solo runs on the kernels); the grid-sharded paths are held to the JAX
# package's own sharded-against-unsharded bars. MIZ's explicit Tb diffusion
# needs D nx^2 / nt near the canonical grid's (phase 22), so the grid-sharded
# MIZ runs scale D to it
MESH_SHARDS = 4
MESH_SPATIAL = (16384, 64)  # the JAX package's MIZ fused reach, float64
MESH_GRID2D = (2048, 64, 64, (2, 2))  # nx, nt, K, mesh shape
MESH_SPIKE_N = 32768
BAR_GRID_RTOL, BAR_GRID_ATOL = 1e-8, 1e-9  # JAX tests/test_spatial.py:58-90
BAR_SPIKE = 1e-12  # spike and sharded diffusion vs pcr_solve/diffusion, normwise relative


def mesh_phase(dev, smi, K=K_MAIN, canonical=CANONICAL, spatial=MESH_SPATIAL,
               grid2d=MESH_GRID2D, spike_n=MESH_SPIKE_N):
    """Phase 23; the shapes are arguments so that a rehearsal on the CPU can
    run it small (there it holds no launch counts). Returns the launches of
    each mesh path and the walls."""
    import torch

    import energybalancemodel_jl_tpu_torch as ebt
    from energybalancemodel_jl_tpu_torch.ops.classic_year import classic_year
    from energybalancemodel_jl_tpu_torch.ops.diffusion import diffusion
    from energybalancemodel_jl_tpu_torch.ops.miz_year import miz_year
    from energybalancemodel_jl_tpu_torch.ops.tridiag import pcr_solve, tridiag_solve
    from energybalancemodel_jl_tpu_torch.parallel import mesh as M
    from energybalancemodel_jl_tpu_torch.parallel.grid2d import (ensemble_spatial_integrate,
                                                                 grid2d_mesh)
    from energybalancemodel_jl_tpu_torch.parallel.halo import grid_mesh, sharded_diffusion
    from energybalancemodel_jl_tpu_torch.parallel.sharding import ensemble_mesh
    from energybalancemodel_jl_tpu_torch.parallel.spatial import spatial_integrate

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    mesh = ensemble_mesh(MESH_SHARDS, device=dev)
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    zn = lambda a: np.nan_to_num(np.asarray(a, dtype=np.float64))
    run = {"walls": {}}

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def launches(counter, fn, want, what):
        """``fn()`` with ``counter``'s count set to 0 just before and read
        just after; on the card it must be ``want``."""
        counter.launches = 0
        out, wall = timed(fn)
        n = counter.launches
        if on_card and n != want:
            fail(f"phase 23 {what}: {n} {counter.__name__} launches, {want} expected")
        return out, wall, n

    def same_tree(a, b, what):
        for k in a:
            if not np.array_equal(np.asarray(a[k]), np.asarray(b[k]), equal_nan=True):
                fail(f"phase 23 {what}: {k} differs from the unsharded run")

    def in_turns(counter, unsharded, sharded, want, what):
        """Unsharded, sharded, sharded, unsharded (the first call of each
        pays first-use costs); the launches of every sharded call held to
        ``want``. Returns both results and the walls of the second turns."""
        ref, _, _ = launches(counter, unsharded, want[0], what + " unsharded")
        got, _, n = launches(counter, sharded, want[1], what)
        _, wall_s, _ = launches(counter, sharded, want[1], what)
        _, wall_u, _ = launches(counter, unsharded, want[0], what + " unsharded")
        return ref, got, wall_s, wall_u, n

    # (a) the fused ensembles, one year, members split over the shards
    st1 = ebt.SpaceTime.sin(*canonical, 1)
    for model, year in (("MIZ", miz_year), ("Classic", classic_year)):
        par = ebt.default_parameters(model)
        par["D"] = np.linspace(0.55, 0.65, K)
        init = (ebt.zeros_init(st1) if model == "MIZ" else
                ebt.Collection(E=np.full(st1.nx, 30.0), Tg=np.full(st1.nx, 30.0 / par["cw"])))
        kw = dict(engine="fused", dtype="float32", progress=False)
        ref, got, wall4, wall1, n = in_turns(
            year, lambda: ebt.ensemble_integrate(model, st1, ebt.Forcing(0.0), par, init,
                                                 device=dev, **kw),
            lambda: ebt.ensemble_integrate(model, st1, ebt.Forcing(0.0), par, init, mesh=mesh,
                                           **kw),
            (1, MESH_SHARDS), f"{model} ensemble_integrate(mesh=)")
        for store in ("winter", "summer", "avg"):
            same_tree(getattr(got.seasonal, store), getattr(ref.seasonal, store),
                      f"{model} {store}")
        run[model] = n
        run["walls"][f"ensemble_integrate {model}"] = (wall4, wall1)
        say(23, f"ensemble_integrate({model!r}, {st1!r}, K={K}, f32, engine='fused', "
                f"mesh={MESH_SHARDS} shards on {dev}): {n} {year.__name__} launches (one per "
                f"shard), every seasonal store bitwise the unsharded year; wall {wall4:.3f} s "
                f"sharded, {wall1:.3f} s unsharded (the second of each, in turns); {smi}")

    # (b) transitions, keys mode (K7), one year, from the states of two
    # 40-year runs (phase 13's references)
    mpar = ebt.default_parameters("MIZ")
    st40 = ebt.SpaceTime.sin(*canonical, 40)
    refs = []
    for F in (15.0, -25.0):
        sol = ebt.integrate("MIZ", st40, ebt.Forcing(F), mpar, ebt.zeros_init(st40),
                            dtype="float32", device=dev, progress=False)
        refs.append(ebt.Collection({k: sol.raw[k][-1] for k in ("Ei", "Ew", "h", "D", "phi")}))
    tkw = dict(sigma=4.0, tau=0.05, K=K, seed=0, dtype="float32", years=1, engine="fused")
    # each run: its year plus one deterministic reference year per attractor
    ref, got, wall4, wall1, n = in_turns(
        miz_year, lambda: ebt.transitions("MIZ", st1, ebt.Forcing(0.0), mpar, *refs,
                                          device=dev, **tkw),
        lambda: ebt.transitions("MIZ", st1, ebt.Forcing(0.0), mpar, *refs, mesh=mesh, **tkw),
        (3, 2 + MESH_SHARDS), "transitions(mesh=)")
    same_tree(got.state, ref.state, "transitions state")
    for name in ("areas", "eta", "labels"):
        if not np.array_equal(getattr(got, name), getattr(ref, name), equal_nan=True):
            fail(f"phase 23 transitions(mesh=): {name} differs from the unsharded run")
    run["transitions"] = n - 2
    run["walls"]["transitions MIZ keys"] = (wall4, wall1)
    say(23, f"transitions('MIZ', {st1!r}, K={K}, keys/serial, 1 year, mesh={MESH_SHARDS}): "
            f"{n - 2} noisy miz_year launches (one per shard) + 2 reference years, areas, eta, "
            f"labels and the final state bitwise the unsharded run; wall {wall4:.3f} s "
            f"sharded, {wall1:.3f} s unsharded")

    # (c) spike and the sharded stencil at spike_n rows, float64
    g = np.random.default_rng(23)
    lo, up = g.normal(size=spike_n), g.normal(size=spike_n)
    lo[0] = up[-1] = 0.0
    di = np.abs(lo) + np.abs(up) + 1.0 + g.uniform(0, 1, spike_n)
    bands = [torch.as_tensor(v, device=dev) for v in (lo, di, up, g.normal(size=spike_n))]
    gmesh = grid_mesh(MESH_SHARDS, device=dev)
    spike = M.shard_map(lambda *a: tridiag_solve(*a, method="spike", axis_name="x"), gmesh,
                        (M.P("x"),) * 4, M.P("x"))
    spike(*bands)  # the first call pays the dense solver's set-up
    (xs, ws), (xp, wp) = timed(lambda: spike(*bands)), timed(lambda: pcr_solve(*bands))
    e_spike = float((xs - xp).abs().max() / xp.abs().max())
    st_d = ebt.SpaceTime.sin(spike_n, 64, 1)
    T = torch.as_tensor(g.normal(size=spike_n) * 30.0, device=dev)
    (ds, wds), (dp, wdp) = (timed(lambda: sharded_diffusion(st_d, gmesh)(T, 0.6)),
                            timed(lambda: diffusion(T, st_d, {"D": 0.6})))
    e_diff = float((ds - dp).abs().max() / dp.abs().max())
    if not (e_spike <= BAR_SPIKE and e_diff <= BAR_SPIKE):
        fail(f"phase 23: spike {e_spike:.3e} or sharded diffusion {e_diff:.3e} past "
             f"{BAR_SPIKE:g} of pcr_solve/diffusion")
    run["walls"]["spike"], run["walls"]["sharded_diffusion"] = (ws, wp), (wds, wdp)
    say(23, f"spike (n={spike_n}, f64, {MESH_SHARDS} shards) vs pcr_solve: {e_spike:.3e}; "
            f"sharded_diffusion vs diffusion: {e_diff:.3e} (bar {BAR_SPIKE:g} normwise); wall "
            f"spike {ws * 1e3:.1f} ms, pcr_solve {wp * 1e3:.1f} ms, sharded_diffusion "
            f"{wds * 1e3:.1f} ms, diffusion {wdp * 1e3:.1f} ms")

    # (d) a grid-sharded MIZ run (halo exchange and SPIKE inside Newton)
    def scaled(nx, nt):
        par = ebt.default_parameters("MIZ")
        par["D"] = par["D"] * COUPLING * nt / nx ** 2
        return ebt.SpaceTime.sin(nx, nt, 1), par

    st_s, par_s = scaled(*spatial)
    args = ("MIZ", st_s, ebt.Forcing(0.0), par_s, ebt.zeros_init(st_s))
    kw = dict(lastonly=False, progress=False, dtype="float64")
    got, wall4 = timed(lambda: spatial_integrate(*args, mesh=gmesh, **kw))
    ref, wall1 = timed(lambda: ebt.integrate(*args, engine="scan", device=dev, **kw))
    worst = 0.0
    for k in ref.raw:
        a, b = zn(got.raw[k]), zn(ref.raw[k])
        if not np.isfinite(a).all():
            fail(f"phase 23 spatial_integrate: {k} is not finite")
        if not np.allclose(a, b, rtol=BAR_GRID_RTOL, atol=BAR_GRID_ATOL):
            fail(f"phase 23 spatial_integrate: raw {k} differs from the unsharded run by "
                 f"{np.max(np.abs(a - b)):.3e}")
        worst = max(worst, float(np.max(np.abs(a - b))))
    run["walls"]["spatial_integrate MIZ"] = (wall4, wall1)
    say(23, f"spatial_integrate('MIZ', {st_s!r}, D scaled, f64, {MESH_SHARDS} grid shards) vs "
            f"the unsharded eager integrate on the card: every raw step within rtol "
            f"{BAR_GRID_RTOL:g} atol {BAR_GRID_ATOL:g} (max |diff| {worst:.3e}); wall "
            f"{wall4:.1f} s sharded, {wall1:.1f} s unsharded")

    # (e) members x grid on a 2-D mesh against the batched ensemble
    nx, nt, K2, shape = grid2d
    st_g, par_g = scaled(nx, nt)
    par_g["D"] = np.linspace(par_g["D"], 1.1 * par_g["D"], K2)
    kw = dict(progress=False, dtype="float64")
    got, wall4 = timed(lambda: ensemble_spatial_integrate(
        "MIZ", st_g, ebt.Forcing(0.0), par_g, ebt.zeros_init(st_g),
        mesh=grid2d_mesh(*shape, device=dev), **kw))
    ref, wall1 = timed(lambda: ebt.ensemble_integrate(
        "MIZ", st_g, ebt.Forcing(0.0), par_g, ebt.zeros_init(st_g), engine="batched",
        device=dev, **kw))
    worst = 0.0
    for store in ("winter", "summer", "avg"):
        for k, b in getattr(ref.seasonal, store).items():
            a = zn(getattr(got.seasonal, store)[k])
            if not np.allclose(a, zn(b), rtol=BAR_GRID_RTOL, atol=BAR_GRID_ATOL):
                fail(f"phase 23 ensemble_spatial_integrate: {store}.{k} differs from the "
                     f"batched ensemble by {np.max(np.abs(a - zn(b))):.3e}")
            worst = max(worst, float(np.max(np.abs(a - zn(b)))))
    run["walls"]["ensemble_spatial_integrate MIZ"] = (wall4, wall1)
    say(23, f"ensemble_spatial_integrate('MIZ', {st_g!r}, K={K2}, D scaled and swept, f64, "
            f"mesh {shape}) vs the batched ensemble on the card: every seasonal store within "
            f"rtol {BAR_GRID_RTOL:g} atol {BAR_GRID_ATOL:g} (max |diff| {worst:.3e}); wall "
            f"{wall4:.1f} s sharded, {wall1:.1f} s unsharded")
    say(23, f"phase 23: {time.perf_counter() - t_phase:.1f} s; walls (sharded, unsharded) s: "
            + json.dumps(run["walls"]))
    return run


def main():
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA device")
    import energybalancemodel_jl_tpu_torch as ebt
    from energybalancemodel_jl_tpu_torch.integrate import resolve_engine
    from energybalancemodel_jl_tpu_torch.models.base import (StepConfig, default_step_config,
                                                              dtype_name, get_model)
    from energybalancemodel_jl_tpu_torch.ops import _build, _year, prng
    from energybalancemodel_jl_tpu_torch.ops import classic_year as classic_mod
    from energybalancemodel_jl_tpu_torch.ops.classic_year import (classic_year,
                                                                   classic_year_reference)
    from energybalancemodel_jl_tpu_torch.ops.diffusion import diffusion_bands
    from energybalancemodel_jl_tpu_torch.ops.miz_year import (CARRY_KEYS, miz_year,
                                                               miz_year_reference)
    from energybalancemodel_jl_tpu_torch.ops.newton_t0 import newton_t0, newton_t0_reference
    from energybalancemodel_jl_tpu_torch.ops.normal_table import normal_from_bits, normal_table
    from energybalancemodel_jl_tpu_torch.ops.pcr_fused import pcr_fused
    from energybalancemodel_jl_tpu_torch.ops.tridiag import pcr_solve
    from energybalancemodel_jl_tpu_torch.tools.kernel_times import ptxas_rows

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
    from energybalancemodel_jl_tpu_torch.utils.numerics import addcmul_is_fma
    say(1, "the plain float32 version's fused multiply-add (utils/numerics.py::fma_f32): "
           + ("torch.addcmul, one rounding on this card" if addcmul_is_fma("cuda")
              else "the float64 emulation (torch.addcmul rounds twice here)"))

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    say(2, f"built csrc/*.cu in {time.perf_counter() - t0:.1f} s")
    ptxas = ptxas_rows(_build.build_log())
    say(2, "ptxas (kernel<dtype, template values>): " + " | ".join(
        f"{name} {used}" for name, used in ptxas.items()))
    occupancy = check_miz_occupancy(ptxas)
    say(2, "MIZ builds of the canonical grid, blocks of 192 threads per SM: " + ", ".join(
        f"{dt} {kind}{' count' if cnt else ''} {b}" for (dt, kind, cnt), b in occupancy.items())
        + f" (needed: {MIZ_BLOCKS_PER_SM})")
    classic_occ = check_classic_occupancy(ptxas)
    say(2, "Classic and K11 builds, registers and members (systems) per SM (design): " + ", ".join(
        f"{name} {regs} regs {members} ({want})"
        for name, (regs, members, want) in classic_occ.items()))
    wide_builds = check_wide_builds(ptxas)
    say(2, "wide builds (the cluster builds of both year kernels, K11 and K10), "
        "registers, no spill stores: "
        + ", ".join(f"{name} {used}" for name, used in wide_builds.items()))

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

    bitwise = _bitwise

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
    # at the main path's shape the plain year's cost grows with the Newton
    # iterations (the adaptive run makes 0.4-1.2 updates per member-step,
    # measured on an H100): 2 fixed iterations keep those checks short
    fixed_short = dataclasses.replace(fixed32, newton_max_iter=2)
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
    out_k = years(miz_year, carry, par, f, st, fixed_short, 1)
    out_p = years(miz_year_reference, carry, par, f, st, fixed_short, 1)
    wmain = compare(out_k, out_p, "f32 canonical", BAR_F32_FIXED)
    say(3, f"f32 canonical K={K_MAIN} 1y, 2 fixed Newton iterations: max|kernel-plain| "
           f"carry={wmain['carry']:.3e} seasonal={wmain['seasonal']:.3e} "
           f"(bar {BAR_F32_FIXED}: bitwise)")
    del out_k, out_p

    cfg32 = default_step_config("float32")
    x = st.x
    hemi = lambda v: np.sum((v[:, :-1] + v[:, 1:]) * (x[1:] - x[:-1]) / 2.0, axis=-1)
    ck, sk, conv_k, _ = years(miz_year, carry, par, f, st, cfg32, 1)
    # the plain year held here is also the kernel table's plain time (phase 6)
    t0 = time.perf_counter()
    cp, sp, conv_p, _ = years(miz_year_reference, carry, par, f, st, cfg32, 1)
    miz_plain_ms = (time.perf_counter() - t0) * 1e3
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
    # kernel: CUDA events over 3 launches after a warm-up that counts each
    # member's Newton updates; plain (host clock): f32 K=8192 only, the
    # kernel table's row, timed where phase 3 holds it
    timing, det_updates = {}, {}
    for dtype in (torch.float32, torch.float64):
        cfg = default_step_config(dtype_name(dtype))
        for K in (1, K_MAIN):
            st, par, carry, f = setup(*CANONICAL, K, dtype)
            updates = torch.zeros(K, dtype=torch.int32, device=dev)
            miz_year(carry, par, f, st, cfg, newton_iters=updates)
            det_updates[dtype, K] = int(updates.sum())
            want = NEWTON_UPDATES.get((dtype_name(dtype), K))
            if want is not None and det_updates[dtype, K] != want:
                fail(f"MIZ {dtype_name(dtype)} K={K} from zero init: {det_updates[dtype, K]} "
                     f"Newton updates in the year, {want} before the redesign")
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                miz_year(carry, par, f, st, cfg)
            stop.record()
            torch.cuda.synchronize()
            kernel_ms = start.elapsed_time(stop) / 3
            # the plain version: phase 3's year on the same inputs
            plain_ms = miz_plain_ms if dtype == torch.float32 and K == K_MAIN else None
            timing[dtype, K] = kernel_ms, plain_ms
            row = dict(dtype=str(dtype), K=K, kernel_ms_per_year=kernel_ms,
                       plain_ms_per_year=plain_ms, gpu=smi,
                       kernel_model_years_per_day=K / kernel_ms * 864e5,
                       newton_updates_per_member_step=det_updates[dtype, K] / K / st.nt,
                       newton_updates=det_updates[dtype, K])
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

    def on_build(kind, fn):
        """``fn()`` with the Classic grids of nx <= 256 on the kernel's warp
        builds from K = 1 (``"warp"``) or on its block build (``"block"``)."""
        saved = classic_mod.WARP_MIN_K
        classic_mod.WARP_MIN_K = 1 if kind == "warp" else 2 ** 30
        try:
            return fn()
        finally:
            classic_mod.WARP_MIN_K = saved

    def from_pool(result):
        """A pooled plain year's results as tensors on the card, in the
        order ``compare`` reads (carry, seasonal stores, -, the rest)."""
        (carry, seasonal, rest), _ = result
        on = lambda c: ebt.Collection({k: torch.as_tensor(v, device=dev) for k, v in c.items()})
        return (on(carry), tuple(on(c) for c in seasonal), None,
                *(None if v is None else on(v) if isinstance(v, dict)
                  else torch.as_tensor(v, device=dev) for v in rest))

    to_np = lambda c: {k: v.cpu().numpy() for k, v in c.items()}
    small, small_tasks = [], []
    for dtype in (torch.float64, torch.float32):
        for warm, build in ((True, "warp"), (False, "warp"), (True, "block")):
            st, par, carry, f = classic_setup(40, 1000, 8, dtype, warm, ("D", "S1", "F"))
            out_k = on_build(build, lambda: years(classic_year, carry, par, f, st, cfg_of(dtype),
                                                  2, raw_last=True))
            label = (f"classic {dtype_name(dtype)} nx=40 {'warm' if warm else 'zeros'} "
                     f"{build} build")
            small.append((label, out_k))
            small_tasks.append(("Classic", dtype_name(dtype), to_np(carry), dict(par),
                                f.cpu().numpy(), cfg_of(dtype), {}, (40, 1000), 2, True))
    # the plain years at once, each in a process of its own
    t_pool = time.perf_counter()
    small_plain = _plain_pool(small_tasks)
    say(7, f"the {len(small_tasks)} plain pairs of years in processes of their own: "
           f"{time.perf_counter() - t_pool:.1f} s wall")
    wsmall = {}
    for (label, out_k), res in zip(small, small_plain):
        w = compare(out_k, from_pool(res), label, BAR_BITWISE)
        wsmall[label] = max(w.values())
        say(7, f"{label} nt=1000 K=8 D,S1,F swept 2y (year 2 raw-collected): "
               f"max|kernel-plain| carry={w['carry']:.3e} seasonal={w['seasonal']:.3e} "
               f"raw={w['raw']:.3e} (bar {BAR_BITWISE}: bitwise)")
    del small, small_plain

    st, par, carry_c, f = classic_setup(*CANONICAL, K_MAIN, torch.float32)
    ck_out = years(classic_year, carry_c, par, f, st, cfg_of(torch.float32), 1)
    # the plain year held here is also the kernel table's plain time (phase 10)
    t0 = time.perf_counter()
    cp_out = years(classic_year_reference, carry_c, par, f, st, cfg_of(torch.float32), 1)
    classic_plain_ms = (time.perf_counter() - t0) * 1e3
    wcl = compare(ck_out, cp_out, "classic f32 canonical", BAR_BITWISE)
    del cp_out
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
    kernel_time = _event_ms

    def device_time(fn, n, kernel):
        """ms per call that the device spent in kernels whose name holds
        ``kernel`` (torch.profiler), or None when it recorded no device time:
        beside ``kernel_time``, which also holds what the host takes to issue
        a call, this tells a kernel's own time from its wrapper's."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
                    for e in prof.key_averages() if kernel in e.key)
        return total / n / 1e3 if total else None

    def host_time(fn, n):
        """ms per call by host clock over n calls, synchronised."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    ctiming = {}
    # the K dispatch of ops/classic_year.py (WARP_MIN_K): both builds at K
    # around it, f32, the canonical grid
    build_ms = {}
    for K in sorted({1, max(1, classic_mod.WARP_MIN_K - 1), classic_mod.WARP_MIN_K, 132}):
        st, par, carry, f = classic_setup(*CANONICAL, K, torch.float32)
        for build in ("warp", "block"):
            build_ms[K, build] = on_build(build, lambda: kernel_time(
                lambda: classic_year(carry, par, f, st, cfg_of(torch.float32)), 3))
    say(10, json.dumps(dict(kernel="classic_year", dtype="torch.float32", gpu=smi,
                            warp_min_k=classic_mod.WARP_MIN_K,
                            ms_per_year_by_build={f"K={K} {b}": v
                                                  for (K, b), v in build_ms.items()})))
    for dtype in (torch.float32, torch.float64):
        for K in (1, K_MAIN):
            st, par, carry, f = classic_setup(*CANONICAL, K, dtype)
            cfg = cfg_of(dtype)
            k_ms = kernel_time(lambda: classic_year(carry, par, f, st, cfg), 3)
            # the plain version: phase 7's year on the same inputs (f32 K=8192)
            p_ms = classic_plain_ms if dtype == torch.float32 and K == K_MAIN else None
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
    pcr_device_ms = device_time(lambda: pcr_fused(*bands, b), 20, "pcr_")
    pcr_plain_ms = host_time(lambda: pcr_solve(*bands, b), 20)
    say(10, json.dumps(dict(kernel="pcr_fused", shape=f"({K_MAIN}, {nx}) f32 per-system bands",
                            kernel_ms_per_call=pcr_ms, device_ms_per_call=pcr_device_ms,
                            plain_ms_per_call=pcr_plain_ms, gpu=smi)))
    newton_ms = kernel_time(lambda: newton_t0(*nargs, **nkw), 20)
    newton_device_ms = device_time(lambda: newton_t0(*nargs, **nkw), 20, "newton_t0_kernel")
    newton_plain_ms = host_time(lambda: newton_t0_reference(*nargs, **nkw), 5)
    say(10, json.dumps(dict(kernel="newton_t0", shape=f"({K_MAIN}, {nx}) f32, 6 iterations",
                            kernel_ms_per_call=newton_ms, device_ms_per_call=newton_device_ms,
                            plain_ms_per_call=newton_plain_ms, gpu=smi)))

    # -- 11. the draw kernel against its plain version, bitwise ---------------
    bits = torch.arange(2 ** 23, dtype=torch.int64, device=dev) << 9
    d_bits = normal_from_bits(bits)
    p_bits = prng.normal_from_bits(bits)
    torch.cuda.synchronize()
    if not bitwise(d_bits, p_bits):
        fail("draw kernel: normal_from_bits differs from its plain version")
    del bits, d_bits, p_bits
    keys_main = prng.member_year_keys(0, K_MAIN, 0)
    tab_k = normal_table(keys_main, CANONICAL[1], dev)
    tab_p = prng.normal_table(keys_main, CANONICAL[1], dev)
    torch.cuda.synchronize()
    if not bitwise(tab_k, tab_p):
        fail(f"draw kernel: the ({CANONICAL[1]}, {K_MAIN}) table differs from its plain version")
    say(11, f"draw kernel vs plain: all 2^23 mantissas bitwise; ({CANONICAL[1]}, {K_MAIN}) "
            f"table of seed 0 bitwise; finite={bool(torch.isfinite(tab_k).all())}, "
            f"std={float(tab_k.std()):.5f}")
    del tab_k, tab_p
    # the float64 table has no kernel (plain PyTorch on the card): the card's
    # draws against the same function on the CPU, whose draws the CPU tests
    # hold bitwise to JAX's
    keys_f64 = prng.member_year_keys(3, 500, 2)
    t64_card = prng.normal_table_f64(keys_f64, CANONICAL[1], dev).cpu()
    t64_cpu = prng.normal_table_f64(keys_f64, CANONICAL[1], "cpu")
    off = int((t64_card.view(torch.int64) != t64_cpu.view(torch.int64)).sum())
    if off:
        fail(f"float64 draws: {off} of {t64_cpu.numel()} on the card differ from the CPU's")
    say(11, f"float64 draws, card vs CPU (plain PyTorch both, {t64_cpu.numel()} draws): "
            f"bitwise, {off} differ")

    # -- 12. every noise mode, MIZ and Classic, kernel against plain -----------
    OU = (0.95, 3.0, 0.5)

    def noise_modes(st, K, dtype, seed=5):
        keys = prng.member_year_keys(seed, K, 2)
        table = torch.as_tensor(np.random.default_rng(3).normal(size=(st.nt, K)), dtype=dtype,
                                device=dev)
        modes = {"table": dict(noise=table), "table/OU": dict(noise=table, noise_ou=OU)}
        if dtype == torch.float32:
            thr = float(np.sum(np.diff(st.x))) * 0.3
            modes.update({
                "keys/serial": dict(noise_keys=keys, noise_ou=OU),
                "keys/assoc": dict(noise_keys=keys, noise_ou=OU, ou_assoc=True),
                "keys/crossing": dict(noise_keys=keys, noise_ou=OU, crossing=(thr, 1.0)),
                "keys/assoc/crossing": dict(noise_keys=keys, noise_ou=OU, ou_assoc=True,
                                            crossing=(thr, -1.0)),
            })
        return modes

    def compare_noisy(out_k, out_p, label, bar=None):
        """Carry and seasonal stores as :func:`compare`; the year-end eta and
        the crossing steps bitwise."""
        worst = compare((*out_k[:3], None), (*out_p[:3], None), label, bar)
        for name, a, b in zip(("eta", "crossing"), out_k[3:], out_p[3:]):
            if (a is None) != (b is None) or (a is not None and not bitwise(a, b)):
                fail(f"{label}: {name} differs")
        return max(worst.values())

    def kw_np(kw):
        """A noise mode's keywords with host arrays for a pooled plain year."""
        conv = lambda v: v.cpu().numpy() if torch.is_tensor(v) else v
        return {k: tuple(conv(x) for x in v) if isinstance(v, tuple) else conv(v)
                for k, v in kw.items()}

    noisy, noisy_tasks = [], []
    for model, year, mk in (("MIZ", miz_year, setup),
                            ("Classic", classic_year,
                             lambda nx, nt, K, dtype: classic_setup(nx, nt, K, dtype))):
        for dtype in (torch.float32, torch.float64):
            shape = (40, 200) if model == "MIZ" else (40, 1000)
            st, par, carry, f = mk(*shape, 8, dtype)
            adaptive = model == "MIZ" and dtype == torch.float64
            cfg = cfg64 if adaptive else (fixed32 if model == "MIZ" else cfg_of(dtype))
            for mode, kw in noise_modes(st, 8, dtype).items():
                noisy.append((f"{model} {dtype_name(dtype)} {mode}",
                              year(carry, par, f, st, cfg, **kw),
                              None if adaptive else BAR_BITWISE))
                noisy_tasks.append((model, dtype_name(dtype), to_np(carry), dict(par),
                                    f.cpu().numpy(), cfg, kw_np(kw), shape))
    # the plain years at once, at most eight at a time, each in a process
    t_pool = time.perf_counter()
    noisy_plain = _plain_pool(noisy_tasks)
    say(12, f"the {len(noisy_tasks)} plain noisy years in processes of their own: "
            f"{time.perf_counter() - t_pool:.1f} s wall")
    noise_err = {}
    for (label, out_k, bar), res in zip(noisy, noisy_plain):
        noise_err[label] = compare_noisy(out_k, from_pool(res), label, bar)
    del noisy, noisy_plain
    say(12, "noise modes, kernel vs plain at nx=40 K=8 (MIZ nt=200, Classic nt=1000; MIZ f32 "
            "with 8 fixed Newton iterations, MIZ f64 adaptive at rtol=atol=1e-8, the rest "
            "bitwise; eta and crossing steps bitwise): " + ", ".join(
                f"{k} {v:.3e}" for k, v in noise_err.items()))

    # sigma = 0: the noisy kernels are the deterministic kernel, bitwise
    for model, year, mk in (("MIZ", miz_year, setup), ("Classic", classic_year, classic_setup)):
        st, par, carry, f = mk(*CANONICAL, K_MAIN, torch.float32)
        # MIZ: each member's Newton updates counted, equal too
        count = (lambda: dict(newton_iters=torch.zeros(K_MAIN, dtype=torch.int32, device=dev))
                 ) if model == "MIZ" else dict
        kw_det = count()
        det = year(carry, par, f, st, cfg32, **kw_det)
        for assoc in (False, True):
            kw_zero = count()
            zero = year(carry, par, f, st, cfg32, noise_keys=keys_main,
                        noise_ou=(0.9, 0.0, 0.0), ou_assoc=assoc, **kw_zero)
            torch.cuda.synchronize()
            same = all(bitwise(zero[0][k], det[0][k]) for k in det[0]) and all(
                bitwise(a[k], b[k]) for a, b in zip(zero[1], det[1]) for k in a) and all(
                torch.equal(kw_zero[k], kw_det[k]) for k in kw_det)
            if not same or bool(zero[3].any()):
                fail(f"{model} sigma=0 noisy kernel (assoc={assoc}) differs from the "
                     "deterministic kernel")
    say(12, f"sigma=0 keys/serial and keys/assoc kernels == the deterministic kernel bitwise "
            f"(MIZ: Newton updates equal too), MIZ and Classic, canonical K={K_MAIN}")
    del det, zero, carry

    # -- 13. the main path: noise-forced transitions through the kernel --------
    counters = (miz_year, classic_year, pcr_fused, newton_t0, normal_table)
    for c in counters:
        c.launches = 0
    mpar = ebt.default_parameters("MIZ")
    st_ref = ebt.SpaceTime.sin(*CANONICAL, 40)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refs = {}
    for name, F in (("a", 15.0), ("b", -25.0)):
        sol = ebt.integrate("MIZ", st_ref, ebt.Forcing(F), mpar, ebt.zeros_init(st_ref),
                            dtype="float32", device=dev, progress=False)
        refs[name] = ebt.Collection({k: sol.raw[k][-1] for k in ("Ei", "Ew", "h", "D", "phi")})
    ref_s = time.perf_counter() - t0
    ref_launches = miz_year.launches
    st1 = ebt.SpaceTime.sin(*CANONICAL, 1)
    tkw = dict(sigma=4.0, tau=0.05, K=K_MAIN, seed=0, dtype="float32", device=dev)
    mode_launches, results = {}, {}
    for mode, years_run, extra in (("keys/serial", 3, {}), ("keys/assoc", 1, dict(ou_impl="assoc")),
                                   ("keys/crossing", 2, dict(subyear=True)),
                                   ("table/OU", 1, dict(dtype="float64"))):
        before = miz_year.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ebt.transitions("MIZ", st1, ebt.Forcing(0.0), mpar, refs["a"], refs["b"],
                              years=years_run, **dict(tkw, **extra))
        wall = time.perf_counter() - t0
        mode_launches[mode] = miz_year.launches - before
        results[mode] = (res, wall)
        finite = bool(np.isfinite(res.areas).all())
        if res.engine != "fused" or res.areas.shape != (years_run, K_MAIN) or not finite:
            fail(f"main path {mode}: engine={res.engine}, areas {res.areas.shape}, "
                 f"finite={finite}")
        # each call runs its years in the mode, plus one deterministic
        # reference year per bare-state attractor
        if mode_launches[mode] != years_run + 2:
            fail(f"main path {mode}: miz_year launched {mode_launches[mode]} times for "
                 f"{years_run} years + 2 reference years")
        mode_launches[mode] -= 2
    main_launches_total = miz_year.launches
    ref_launches_total = ref_launches + 2 * len(mode_launches)
    if ref_launches != 2 * st_ref.dur or main_launches_total != ref_launches_total + sum(
            mode_launches.values()):
        fail(f"main path: miz_year launches {main_launches_total} "
             f"(reference runs {ref_launches})")
    res, wall = results["keys/serial"]
    say(13, f"transitions('MIZ', SpaceTime.sin(180, 2000, 1), Forcing(0.0), sigma=4, tau=0.05, "
            f"K={K_MAIN}, years=3, f32) -> engine={res.engine!r}: {wall:.3f} s, "
            f"{K_MAIN * 3 / wall * 86400.0:.4e} member-years/day, areas finite, "
            f"escape_fraction={res.escape_fraction():.6f}, area_a={float(res.area_a[0]):.6f} "
            f"area_b={float(res.area_b[0]):.6f}, newton_ok={res.newton_ok}; references: 2 x 40 "
            f"years of integrate in {ref_s:.3f} s")
    for mode in ("keys/assoc", "keys/crossing", "table/OU"):
        r, w = results[mode]
        extra = ""
        if mode == "keys/crossing":
            cs = r.crossing_step
            extra = (f", crossing steps recorded {int((cs >= 0).sum())} of {cs.size}, "
                     "first_passage_subyear finite "
                     f"{int(np.isfinite(r.first_passage_subyear()).sum())}")
        say(13, f"  {mode}: {r.years} year(s) in {w:.3f} s, escape_fraction="
                f"{r.escape_fraction():.6f}{extra}")
    say(13, f"miz_year launches: {ref_launches} years of the reference runs + "
            f"{ref_launches_total - ref_launches} deterministic reference-area years + "
            + " + ".join(f"{v} ({k})" for k, v in mode_launches.items())
            + f" = {main_launches_total}")

    # the Classic path: its attractors from 20-year single runs, then every mode,
    # and the scan engine, whose float32 draws come from the draw kernel
    cpar = ebt.default_parameters("Classic")
    st_cref = ebt.SpaceTime.sin(*CANONICAL, 20)
    crefs = {}
    for name, E0 in (("a", 30.0), ("b", -30.0)):
        init = {"E": np.full(CANONICAL[0], E0), "Tg": np.full(CANONICAL[0], E0) / cpar["cw"]}
        sol = ebt.integrate("Classic", st_cref, ebt.Forcing(10.0), cpar, init, dtype="float32",
                            device=dev, progress=False)
        E_last = sol.raw["E"][-1]
        crefs[name] = ebt.Collection({"E": E_last, "Tg": E_last / cpar["cw"]})
    classic_mode_launches, classic_results = {}, {}
    for mode, years_run, extra in (("keys/serial", 2, {}), ("keys/assoc", 1, dict(ou_impl="assoc")),
                                   ("keys/crossing", 1, dict(subyear=True)),
                                   ("table/OU", 1, dict(dtype="float64")),
                                   ("scan", 1, dict(engine="scan"))):
        before = classic_year.launches, normal_table.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the eager scan engine's year on 1000 steps (Classic's shortest
        # stable year): it is host-bound, and only its draw launches count here
        st_mode = ebt.SpaceTime.sin(CANONICAL[0], 1000, 1) if mode == "scan" else st1
        res = ebt.transitions("Classic", st_mode, ebt.Forcing(10.0), cpar, crefs["a"],
                              crefs["b"], years=years_run, **dict(tkw, sigma=8.0, **extra))
        wall = time.perf_counter() - t0
        classic_mode_launches[mode] = classic_year.launches - before[0]
        classic_results[mode] = (res, wall)
        if mode == "scan":
            draw_launches = normal_table.launches - before[1]
            if draw_launches != years_run:
                fail(f"Classic scan engine: the draw kernel launched {draw_launches} times "
                     f"for {years_run} year(s)")
        elif classic_mode_launches[mode] != years_run + 2:
            fail(f"Classic {mode}: classic_year launched {classic_mode_launches[mode]} times")
        else:
            classic_mode_launches[mode] -= 2  # the two reference-area years
        if not np.isfinite(res.areas).all():
            fail(f"Classic transitions {mode}: non-finite areas")
    say(13, "transitions('Classic', SpaceTime.sin(180, 2000, 1) (the scan engine 1000 steps), "
            f"Forcing(10.0), sigma=8, K={K_MAIN}): " + ", ".join(
                f"{mode} {r.years}y {w:.3f} s (engine {r.engine}, escape_fraction "
                f"{r.escape_fraction():.4f}, classic_year +{classic_mode_launches[mode]} "
                f"noisy + {0 if mode == 'scan' else 2} reference)"
                for mode, (r, w) in classic_results.items())
            + f"; draw kernel launches +{draw_launches} (scan engine)")
    for c, n in ((pcr_fused, "pcr_fused"), (newton_t0, "newton_t0")):
        if c.launches:
            fail(f"the transitions paths launched {n}")

    # -- 14. every noise mode at the main path's shape, on its inputs ---------
    # The first year of phase 13's calls: the member keys of seed 0, year 0;
    # the OU rows of its sigma (MIZ 4, Classic 8) and tau = 0.05 from eta0 = 0;
    # the starting state a; the base forcing (MIZ 0, Classic 10). Crossing
    # thresholds spread over [0, 1] with alternating signs, so that members
    # cross (at the main path's midpoint none did in phase 13). Each mode that
    # phase 13 runs is held against its plain version, bitwise: MIZ (f32 and
    # f64) with 2 fixed Newton iterations, Classic as it runs. The kernel runs
    # all K=8192 members; the plain version runs HOLD_MEMBERS of them, spread
    # over the ensemble, each with its own keys, OU row, noise column and
    # threshold (members are independent: a member of a year is its run
    # alone), in three plain years per model: keys/crossing (which holds
    # keys/serial too: the same members, keys and OU rows), keys/assoc and the
    # table sharing one (each mode's per-step offsets as columns of one noise
    # table, noise_offsets), and the float64 table/OU; the six run at once,
    # each in a process of its own, after every kernel here is timed. Each
    # mode is timed as its path runs it (the adaptive Newton, each member's
    # Newton updates counted); its plain time is the plain year that holds it
    # (the kernel table's plain_config says which); MIZ's plain years have 2
    # fixed Newton iterations per step, so the kernel is also timed so,
    # beside them (the kernel table's ms_plain_config); table/OU also in
    # float32, beside its float64 path.
    nt = CANONICAL[1]
    rho = float(np.exp(-1.0 / nt / 0.05))
    keys_dev = prng.member_year_keys(0, K_MAIN, 0)
    thr_sgn = (torch.linspace(0.0, 1.0, K_MAIN, device=dev),
               torch.tensor([1.0, -1.0], device=dev).repeat(K_MAIN // 2))
    # spread over the ensemble, both crossing signs (alternating parity)
    held = np.array([(K_MAIN // HOLD_MEMBERS) * j + (j % 2) for j in range(HOLD_MEMBERS)])
    held_dev = torch.as_tensor(held, device=dev)

    def held_out(out):
        """A year's results (carry, seasonal, -, eta[, crossing]) at the held
        members."""
        cut = lambda c: ebt.Collection({k: v[held_dev] for k, v in c.items()})
        return (cut(out[0]), tuple(cut(c) for c in out[1]), None,
                *(None if v is None else v[held_dev] for v in out[3:]))

    def held_kw(kw):
        """A mode's noise arguments for the held members."""
        sub = {}
        for k, v in kw.items():
            if k == "noise_keys":
                sub[k] = v[held]
            elif k == "noise_ou":
                sub[k] = (v[0], v[1], v[2][held_dev])
            elif k == "crossing":
                sub[k] = tuple(x[held_dev] for x in v)
            elif k == "noise":
                sub[k] = v[:, held_dev].contiguous()
            else:
                sub[k] = v
        return sub

    timed, plain_timed, updates, main_err, crossed = {}, {}, {}, {}, {}
    timed_fixed = {}  # MIZ: the kernel with the plain run's 2 fixed Newton iterations
    plain_config = {}  # the plain year that holds each mode
    plain_tasks, kernels_held, held_eta, modes_of = [], {}, {}, {}
    for model, year, plain, state, par, sigma, F in (
            ("MIZ", miz_year, miz_year_reference, refs["a"], mpar, 4.0, 0.0),
            ("Classic", classic_year, classic_year_reference, crefs["a"], cpar, 8.0, 10.0)):
        spec = get_model(model)
        inputs = {}
        for dtype in (torch.float32, torch.float64):
            carry = spec.init_carry(state, st1, dtype, dev)
            carry = ebt.Collection({k: v.expand((K_MAIN,) + tuple(v.shape)).contiguous()
                                    for k, v in carry.items()})
            ou = (rho, sigma * float(np.sqrt(1.0 - rho * rho)),
                  torch.zeros(K_MAIN, dtype=dtype, device=dev))
            inputs[dtype] = (carry, par, torch.full((nt,), F, dtype=dtype, device=dev), st1), ou
        ou32, ou64 = inputs[torch.float32][1], inputs[torch.float64][1]
        table32 = prng.normal_table(keys_dev, nt, dev)
        modes = {
            "det": (torch.float32, {}),
            # the noisy build at sigma = 0: its cost on the deterministic path
            "sigma0": (torch.float32, dict(noise_keys=keys_dev, noise_ou=(rho, 0.0, ou32[2]))),
            "keys/serial": (torch.float32, dict(noise_keys=keys_dev, noise_ou=ou32)),
            "keys/assoc": (torch.float32, dict(noise_keys=keys_dev, noise_ou=ou32,
                                               ou_assoc=True)),
            "keys/crossing": (torch.float32, dict(noise_keys=keys_dev, noise_ou=ou32,
                                                  crossing=thr_sgn)),
            "table/OU": (torch.float64, dict(noise=prng.normal_table_f64(keys_dev, nt, dev),
                                             noise_ou=ou64)),
            "table/OU f32": (torch.float32, dict(noise=table32, noise_ou=ou32)),
            # an ops-level mode that no entry point runs (K5)
            "table": (torch.float32, dict(noise=table32)),
        }
        # the kernel at the held members, in the configuration its plain
        # version runs (MIZ: 2 fixed Newton iterations)
        kernel_held = {}
        for mode, (dtype, kw) in modes.items():
            args, cfg = inputs[dtype][0], cfg_of(dtype)
            if model == "MIZ":
                n = torch.zeros(K_MAIN, dtype=torch.int32, device=dev)
                year(*args, cfg, newton_iters=n, **kw)
                updates[model, mode] = int(n.sum())
                if updates[model, mode] != NEWTON_UPDATES.get(mode, updates[model, mode]):
                    fail(f"MIZ {mode}: {updates[model, mode]} Newton updates in the year, "
                         f"{NEWTON_UPDATES[mode]} before the redesign")
            timed[model, mode] = kernel_time(lambda: year(*args, cfg, **kw), 2)
            if mode in ("det", "sigma0", "table/OU f32"):
                continue
            held_cfg = fixed_short if model == "MIZ" else cfg
            if model == "MIZ":
                timed_fixed[model, mode] = kernel_time(lambda: year(*args, held_cfg, **kw), 2)
            out_k = year(*args, held_cfg, **kw)
            if mode == "keys/crossing":
                crossed[model] = int((out_k[4] >= 0).sum())
            kernel_held[mode] = held_out(out_k)
            del out_k
        # the three plain years of the held members, as numpy for the
        # processes that run them
        cpu = lambda v: None if v is None else (v.cpu().numpy() if torch.is_tensor(v) else v)
        carry32, carry64 = ({k: cpu(v[held_dev]) for k, v in inputs[d][0][0].items()}
                            for d in (torch.float32, torch.float64))
        held_cfg = fixed_short if model == "MIZ" else cfg_of(torch.float32)
        f32_row, f64_row = (cpu(inputs[d][0][2]) for d in (torch.float32, torch.float64))
        numpy_kw = lambda kw: {k: tuple(cpu(x) for x in v) if isinstance(v, tuple) else cpu(v)
                               for k, v in held_kw(kw).items()}
        # keys/assoc and the table: their offsets as the columns of one table
        akw = held_kw(modes["keys/assoc"][1])
        assoc_off, assoc_eta = _year.noise_offsets(None, akw["noise_ou"], akw["noise_keys"],
                                                   True, HOLD_MEMBERS, nt, torch.float32, dev)
        both_noise = torch.cat([assoc_off, held_kw(modes["table"][1])["noise"]], dim=1)
        plain_tasks += [
            ((model, "p1"), (model, "float32", carry32, dict(par), f32_row, held_cfg,
                             numpy_kw(modes["keys/crossing"][1]))),
            ((model, "p2"), (model, "float32",
                             {k: np.concatenate([v, v]) for k, v in carry32.items()},
                             dict(par), f32_row, held_cfg, {"noise": cpu(both_noise)})),
            ((model, "p3"), (model, "float64", carry64, dict(par), f64_row,
                             fixed_short if model == "MIZ" else cfg_of(torch.float64),
                             numpy_kw(modes["table/OU"][1])))]
        held_eta[model] = assoc_eta
        kernels_held[model] = kernel_held
        modes_of[model] = {m: d for m, (d, _) in modes.items()}
        del inputs, modes, table32

    # the six plain years at once, each in a process of its own (they are
    # bound by the host's launches, one core each; the kernels above were
    # timed before they start)
    import multiprocessing

    t_plain = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(len(plain_tasks)) as pool:
        plains = dict(zip([key for key, _ in plain_tasks],
                          pool.starmap(_held_plain_task, [args for _, args in plain_tasks])))
    t_plain = time.perf_counter() - t_plain
    on_dev = lambda v: None if v is None else torch.as_tensor(v, device=dev)

    def plain_out(key, j=None):
        """A plain year's results as tensors on the card; with j, the j-th
        block of HOLD_MEMBERS members."""
        (carry, seasonal, rest), _ = plains[key]
        cut = (lambda c: ebt.Collection({k: on_dev(v if j is None else
                                                   v[j * HOLD_MEMBERS:(j + 1) * HOLD_MEMBERS])
                                         for k, v in c.items()}))
        return (cut(carry), tuple(cut(c) for c in seasonal), None, *(on_dev(v) for v in rest))

    for model in ("MIZ", "Classic"):
        kernel_held = kernels_held[model]
        ms = {key[1]: plains[key][1] for key in plains if key[0] == model}
        p1 = plain_out((model, "p1"))
        for mode in ("keys/crossing", "keys/serial"):
            label = f"{model} float32 canonical K={K_MAIN} {mode}"
            want = p1 if mode == "keys/crossing" else p1[:4]
            main_err[model, mode] = compare_noisy(kernel_held[mode], want, label, BAR_BITWISE)
            plain_timed[model, mode] = ms["p1"]
            plain_config[model, mode] = ("the plain year of keys/crossing on the held members, "
                                         "which holds keys/serial too")
        for j, (mode, eta) in enumerate((("keys/assoc", held_eta[model]), ("table", None))):
            label = f"{model} float32 canonical K={K_MAIN} {mode}"
            want = plain_out((model, "p2"), j)[:3] + (eta,)
            main_err[model, mode] = compare_noisy(kernel_held[mode], want, label, BAR_BITWISE)
            plain_timed[model, mode] = ms["p2"]
            plain_config[model, mode] = ("one plain year on the held members of keys/assoc and "
                                         "the table, each mode's offsets as noise columns")
        main_err[model, "table/OU"] = compare_noisy(
            kernel_held["table/OU"], plain_out((model, "p3")),
            f"{model} float64 canonical K={K_MAIN} table/OU", BAR_BITWISE)
        plain_timed[model, "table/OU"] = ms["p3"]
        plain_config[model, "table/OU"] = "the plain year of table/OU on the held members"
        modes = modes_of[model]
        say(14, json.dumps(dict(
            kernel=f"{model.lower()}_year", K=K_MAIN, gpu=smi,
            dtype={m: dtype_name(d) for m, d in modes.items()},
            ms_per_year={m: timed[model, m] for m in modes},
            plain_ms_per_year={m: plain_timed.get((model, m)) for m in modes},
            plain_members=HOLD_MEMBERS, plain_years_wall_s=t_plain,
            ms_per_year_2_fixed_newton={m: timed_fixed.get((model, m)) for m in modes},
            max_abs_err_kernel_vs_plain={m: main_err.get((model, m)) for m in modes},
            newton_updates_per_member_step={m: updates[model, m] / K_MAIN / nt
                                            for m in modes if (model, m) in updates},
            newton_updates={m: updates[model, m] for m in modes if (model, m) in updates},
            crossings_recorded=f"{crossed[model]} of {K_MAIN}")))
    del kernels_held, plains
    say(14, f"every mode phase 13 runs, kernel vs plain at SpaceTime.sin(180, 2000, 1) "
            f"K={K_MAIN} on its inputs, {HOLD_MEMBERS} members spread over the ensemble held "
            f"bitwise (MIZ with 2 fixed Newton iterations): "
            + ", ".join(
                f"{model} {mode} {e:.3e}" for (model, mode), e in main_err.items()))
    draw_ms = kernel_time(lambda: normal_table(keys_dev, nt, dev), 20)
    draw_plain_ms = host_time(lambda: prng.normal_table(keys_dev, nt, dev), 3)
    say(14, json.dumps(dict(kernel="normal_table", shape=f"({nt}, {K_MAIN}) float32",
                            kernel_ms_per_call=draw_ms, plain_ms_per_call=draw_plain_ms, gpu=smi)))

    eq_run = equilibrium_phases(dev, smi, search_init=search_init_state(dev))
    search_run = search_phases(dev, smi, jobs=eq_run.pop("search_jobs"))
    ckpt_run = checkpoint_phase(dev, smi)
    hr_run = highres_phase(dev, smi)

    # -- the least time the card could take for each kernel's work ------------
    # NVIDIA's H100 SXM data sheet (dense rates, 700 W):
    # 3.35 TB/s, and outside the tensor cores 67 TFLOP/s f32 and 34 TFLOP/s
    # f64, both counting an FMA as two flops. Operations here are flops in the
    # same unit: every add, subtract, multiply, divide, min/max and comparison
    # one, an FMA two. The draws' cipher is counted in 32-bit integer
    # instructions, against 64 INT32 lanes per SM x 132 SMs x 1.98 GHz (the
    # clock at which 128 f32 lanes per SM give the 67 TFLOP/s) = 16.7e12 per
    # second. The floating-point and integer pipes run side by side, so the
    # operation time is the larger of the two.
    HBM, PEAK = 3.35e12, {4: 67e12, 8: 34e12}
    INT32 = 64 * 132 * 1.98e9

    def bound(nbytes, flops, itemsize=4, int_ops=0.0):
        t_bytes = nbytes / HBM
        t_ops = max(flops / PEAK[itemsize], int_ops / INT32)
        return t_bytes * 1e3 if t_bytes >= t_ops else t_ops * 1e3, \
            "bytes" if t_bytes >= t_ops else "operations"

    nx, K = CANONICAL[0], K_MAIN
    pcr_at = lambda n: 5 + 12 * int(np.ceil(np.log2(n)))  # PCR flops per row of an n-row system:
    pcr_flops = pcr_at(nx)  # the row scaling, 12 per level, the last division
    # flops per cell and step, counted from csrc/miz_year.cu and
    # csrc/classic_year.cu: a MIZ step without its Newton updates (step
    # inputs 13, the first T0 residual and bands 35, its block max 7, the
    # tolerance and flag 4, the update of the five fields and the stores
    # 139); each MIZ Newton update is the PCR solve and 46 more (the clipped
    # step 3, a new residual 35, its block max 7, the test 1), a Classic step
    # 40 and its PCR
    miz_step = 198
    draw_int, draw_flops = 118, 50  # one draw: the cipher, then the float pipeline

    def year_bound(model, mode, itemsize=4, newton_updates=0, shape=(K, nx, nt)):
        """A year of ``shape`` (K, nx, nt), the canonical K=8192 year by
        default; ``newton_updates``: the Newton updates of all members, as
        the kernel counted them in this run (or made them: a fixed count)."""
        K, nx, nt = shape
        n_carry, n_out, n_par = (6, 10, 23) if model == "MIZ" else (2, 3, 18)
        nbytes = itemsize * (K * nx * (2 * n_carry + 3 * n_out) + K * (n_par + 1) + 5 * nx
                             + 2 * nt)
        flops = (K * nx * nt * (miz_step if model == "MIZ" else 40 + pcr_at(nx))
                 + nx * newton_updates * (pcr_at(nx) + 46))
        ints = 0.0
        if mode.startswith("keys") or mode == "table/OU":
            nbytes += itemsize * 4 * K  # OU rows in, eta out
            flops += 4 * K * nt
        if mode.startswith("keys"):
            nbytes += 8 * K
            flops += draw_flops * K * nt
            ints += draw_int * K * nt
        if mode.startswith("table"):
            nbytes += itemsize * nt * K
        if mode == "keys/assoc":
            flops += 4 * K * nt * int(np.ceil(np.log2(nt)))
        if mode == "keys/crossing":
            nbytes += itemsize * 3 * K
            flops += 2 * K * nx * nt
        return bound(nbytes, flops, itemsize, ints)

    # library yardstick: the batched tridiagonal solve as one dense torch call
    g = np.random.default_rng(13)
    lo_d, up_d = (torch.as_tensor(g.normal(size=(K, nx)), dtype=torch.float32, device=dev)
                  for _ in range(2))
    dense = (torch.diag_embed(lo_d.abs() + up_d.abs() + 1.0)
             + torch.diag_embed(lo_d[:, 1:], -1) + torch.diag_embed(up_d[:, :-1], 1))
    rhs = torch.as_tensor(g.normal(size=(K, nx, 1)), dtype=torch.float32, device=dev)
    pcr_library_ms = kernel_time(lambda: torch.linalg.solve(dense, rhs), 5)
    del dense, rhs

    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd, library_ms=None,
              **extra):
        return dict(name=name, route="cuda",
                    source=f"energybalancemodel_jl_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches, max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1], library_ms=library_ms,
                    **extra)

    # -- 23. the multi-device layer (M14) on the card -------------------------
    mesh_run = mesh_phase(dev, smi)

    py = "energybalancemodel_jl_tpu/ops/pallas_year.py"
    year_shape = f"K={K} nx={nx} nt={nt} float32, one model year"
    kernels = {"kernels": [
        entry("miz_year", "miz_year.cu", f"{py}:458", main_launches, max(wmain.values()),
              kernel_ms, plain_ms,
              year_bound("MIZ", "det", 4, det_updates[torch.float32, K_MAIN]),
              also_replaces=f"{py}:352",
              max_abs_err_f64_nx40=max(w64.values()), max_abs_err_f32_nx40=max(w32.values()),
              newton_updates_per_member_step=det_updates[torch.float32, K_MAIN] / K / nt,
              shape=year_shape + " from zero init", path="ensemble_integrate (phase 4)",
              # the K=1 years behind the transitions path's references: the
              # kernel alone (phase 6), and as integrate runs them (phase 13)
              launches_transitions_path=ref_launches_total,
              ms_K1=timing[torch.float32, 1][0],
              ms_K1_reference_year=ref_s * 1e3 / ref_launches,
              # the equilibrium layer's path (phases 15, 16): one launch per year
              launches_equilibrate=eq_run["miz"]["launches"],
              equilibrate_kernel_ms_per_year=eq_run["miz"]["kernel_ms_per_year"],
              equilibrate_wall_ms_per_year=eq_run["miz"]["wall_ms_per_year"],
              launches_continuation=eq_run["continuation_launches"],
              # phase 21: the resumes of the checkpointed ensemble and equilibrate
              launches_checkpoint=ckpt_run["ens"]["launches"] + ckpt_run["eq"]["launches"]),
        entry("classic_year", "classic_year.cu", f"{py}:1628", classic_launches, max(wcl.values()),
              ctiming[torch.float32, K_MAIN][0], ctiming[torch.float32, K_MAIN][1],
              year_bound("Classic", "det"), also_replaces=f"{py}:1378",
              max_abs_err_nx40=max(wsmall.values()), max_abs_err_nx4096_K1=max(whi.values()),
              ms_K1=ctiming[torch.float32, 1][0], warp_min_k=classic_mod.WARP_MIN_K,
              shape=year_shape, path="ensemble_integrate (phase 8)",
              launches_equilibrate=eq_run["classic"]["launches"],
              equilibrate_kernel_ms_per_year=eq_run["classic"]["kernel_ms_per_year"],
              equilibrate_wall_ms_per_year=eq_run["classic"]["wall_ms_per_year"],
              # the search drivers' path (phases 18, 19): one launch per year
              launches_fold=search_run["launches"],
              fold_kernel_ms_per_year=search_run["kernel_ms_per_year"],
              launches_basins=search_run["basins_launches"],
              basins_kernel_ms_per_year=search_run["basins_kernel_ms_per_year"],
              launches_edge=search_run["edge_launches"],
              edge_kernel_ms_per_year=search_run["edge_kernel_ms_per_year"],
              # phase 21: the resume of the checkpointed single run
              launches_checkpoint=ckpt_run["classic"]["launches"]),
        entry("pcr_fused", "pcr.cu", "energybalancemodel_jl_tpu/ops/pallas_tridiag.py:29",
              solver_launches["pcr_fused"], pcr_err, pcr_ms, pcr_plain_ms,
              bound(4 * 5 * K * nx, K * nx * pcr_flops), pcr_library_ms,
              library_call="torch.linalg.solve on the dense (K, n, n) systems",
              device_ms=pcr_device_ms,
              shape=f"({K}, {nx}) float32, one solve", path="batched engine (phase 9)"),
        entry("newton_t0", "newton_t0.cu", "energybalancemodel_jl_tpu/ops/pallas_newton.py:90",
              solver_launches["pallas"], newton_err, newton_ms, newton_plain_ms,
              bound(4 * (6 * K * nx + 3 * nx + K), K * nx * 6 * (33 + pcr_flops + 3)),
              device_ms=newton_device_ms,
              shape=f"({K}, {nx}) float32, 6 Newton iterations", path="batched engine (phase 9)"),
        entry("normal_table", "normal_table.cu", "scripts/tpu_check.py:468", draw_launches, 0.0,
              draw_ms, draw_plain_ms,
              bound(4 * nt * K + 8 * K, draw_flops * nt * K, 4, draw_int * nt * K),
              also_replaces=f"{py}:289", shape=f"({nt}, {K}) float32 draws",
              path="transitions(engine='scan'), Classic (phase 13)"),
    ]}
    k_ids = {"keys/serial": ("K7", f"{py}:682"), "keys/assoc": ("K8", f"{py}:316"),
             "keys/crossing": ("K9", f"{py}:610"), "table/OU": ("K6", f"{py}:654"),
             "table": ("K5", f"{py}:645")}
    c_ids = {"keys/serial": f"{py}:703", "keys/assoc": f"{py}:316", "keys/crossing": f"{py}:1738",
             "table/OU": f"{py}:673", "table": f"{py}:666"}
    for model, src, launches_of, ids in (
            ("MIZ", "miz_year.cu", mode_launches, {m: r for m, (_, r) in k_ids.items()}),
            ("Classic", "classic_year.cu", classic_mode_launches, c_ids)):
        for mode, replaces in ids.items():
            small = max(v for k, v in noise_err.items()
                        if k.startswith(model) and k.endswith(mode))
            f64 = mode == "table/OU"  # the f64 path's mode, timed in f64
            n_upd = updates.get((model, mode), 0)
            kernels["kernels"].append(entry(
                f"{model.lower()}_year[{mode}]", src, replaces, launches_of.get(mode, 0),
                main_err.get((model, mode), small), timed[model, mode],
                plain_timed[model, mode], year_bound(model, mode, 8 if f64 else 4, n_upd),
                tpu_kernel=k_ids[mode][0], max_abs_err_nx40=small,
                ms_float32_same_call=timed[model, "table/OU f32"] if f64 else None,
                det_ms_same_call=timed[model, "det"], sigma0_ms_same_call=timed[model, "sigma0"],
                newton_updates_per_member_step=n_upd / K / nt if model == "MIZ" else None,
                plain_config=(f"{plain_config[model, mode]} ({HOLD_MEMBERS} of {K} members); "
                              + ("2 fixed Newton iterations per step; ms: the adaptive Newton"
                                 if model == "MIZ" else "as the path runs")),
                ms_plain_config=timed_fixed.get((model, mode), timed[model, mode]),
                shape=year_shape.replace("float32", "float64") if f64 else year_shape,
                path=("transitions (phase 13)" if launches_of.get(mode, 0)
                      else "none: an ops-level mode, no entry point uses it")))
    # the wide builds (phase 22), each at the shape phase 22 times it and its
    # plain version; launches from phase 22's main paths
    hr, hms = hr_run, hr_run["ms"]
    nxc, nxm, n11, n10 = max(HR_CLASSIC_NX), HR_MIZ_TIMED, max(HR_CLASSIC_NX), max(HR_MIZ_NX)
    worst = lambda d, prefix: max(v for k, v in d.items() if k.startswith(prefix))
    main_plan = lambda key: {k: v for k, v in hr["plans"][key].items()}
    kernels["kernels"] += [
        entry("classic_year[wide]", "classic_year.cu", f"{py}:1378", hr["classic"]["launches"],
              worst(hr["err"], "Classic"), hms["classic"], hms["classic_plain"],
              year_bound("Classic", "det", shape=(1, nxc, HR_CLASSIC_NT)),
              also_replaces=f"{py}:1628",
              max_abs_err_noise_modes=worst(hr["noise_err"], "Classic"),
              s_per_year_main_path=hr["classic"]["s_per_year"],
              design="cluster build (csrc/cluster.cuh): a thread-block cluster per member",
              cluster=main_plan(f"classic_year nx={nxc} K=1 float32"),
              shape=f"K=1 nx={nxc} nt={HR_CLASSIC_NT} float32, one model year",
              path="integrate (phase 22), checkpointed and resumed"),
        entry("miz_year[wide]", "miz_year.cu", f"{py}:352", hr["miz"]["launches"],
              worst(hr["err"], "MIZ"), hms["miz"], hms["miz_plain"],
              year_bound("MIZ", "det", newton_updates=2 * HR_MIZ_NT, shape=(1, nxm, HR_MIZ_NT)),
              also_replaces=f"{py}:458", max_abs_err_noise_modes=worst(hr["noise_err"], "MIZ"),
              s_per_year_main_path=hr["miz"]["s_per_year"], main_path_shape=hr["miz"]["shape"],
              design="cluster build (csrc/cluster.cuh): a thread-block cluster per member",
              cluster=main_plan(f"miz_year nx={HR_MIZ_MAIN[0]} K=1 float32"),
              shape=f"K=1 nx={nxm} nt={HR_MIZ_NT} float32, D scaled, 2 fixed Newton updates",
              path="integrate (phase 22)"),
        entry("pcr_fused[wide]", "pcr.cu", "energybalancemodel_jl_tpu/ops/pallas_tridiag.py:29",
              hr["pcr_fused"]["launches"], worst(hr["k_err"], "K11"), hms["pcr"],
              hms["pcr_plain"], bound(4 * 5 * HR_SYSTEMS * n11, HR_SYSTEMS * n11 * pcr_at(n11)),
              None, library_call=(f"none: the dense ({HR_SYSTEMS}, {n11}, {n11}) systems of "
                                  "torch.linalg.solve would take 275 GB"),
              residual_f32=hr["resid"]["K11 torch.float32 per-system"],
              design=("cluster build (csrc/pcr.cu::pcr_cluster_kernel, csrc/cluster.cuh): a "
                      "thread-block cluster per system, its rows in the ranks' shared memory, "
                      "one cluster barrier per PCR level"),
              cluster=hr["k_plans"]["K11 float32 per-system C=chosen"],
              shape=f"({HR_SYSTEMS}, {n11}) float32, one solve",
              path="batched engine, Classic (phase 22)"),
        entry("newton_t0[wide]", "newton_t0.cu",
              "energybalancemodel_jl_tpu/ops/pallas_newton.py:90", hr["newton_t0"]["launches"],
              worst(hr["k_err"], "K10"), hms["newton"], hms["newton_plain"],
              bound(4 * (6 * HR_SYSTEMS * n10 + 3 * n10 + HR_SYSTEMS),
                    HR_SYSTEMS * n10 * 6 * (33 + pcr_at(n10) + 3)),
              design=("cluster build (csrc/newton_t0.cu::newton_t0_cluster_kernel, "
                      "csrc/cluster.cuh): a thread-block cluster per member, its rows, "
                      "exchange and records in the ranks' shared memory"),
              cluster=hr["k_plans"]["K10 float32 C=chosen"],
              shape=f"({HR_SYSTEMS}, {n10}) float32, 6 Newton iterations",
              path="batched engine, MIZ (phase 22)"),
    ]
    for k in kernels["kernels"]:
        # phase 23's member-sharded paths: one launch per shard per year
        k["launches_mesh"] = {"miz_year": mesh_run["MIZ"], "classic_year": mesh_run["Classic"],
                              "miz_year[keys/serial]": mesh_run["transitions"]}.get(k["name"], 0)
    say(23, f"total {time.perf_counter() - t_start:.0f} s")
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
