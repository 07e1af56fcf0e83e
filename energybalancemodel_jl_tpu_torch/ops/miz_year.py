"""Fused whole-year MIZ integration: the wrapper of the CUDA kernel
``csrc/miz_year.cu`` and its plain PyTorch version.

Port of the JAX package's ``ops/pallas_year.py::pallas_miz_year`` (its 'xk'
launcher ``_miz_year_xk`` and its 'kx' branch): one call runs all ``nt``
steps of a model year for a ``(K, nx)`` ensemble, with the warm-started
Newton solve and the PCR tridiagonal solves inside, and builds the seasonal
store (winter/summer snapshots at the tick indices, annual sums divided by
``nt`` at the end) as it goes; on request it also stores every step's
outputs (a raw-collected year).

:func:`miz_year` dispatches on the device of the carry: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs the plain version
:func:`miz_year_reference` — the port's analogue of the JAX package's
interpret mode off-TPU. The plain version is the scan engine's year loop
(:func:`..integrate.make_year_fn`) on per-member parameter columns. Every
physical or table parameter may be ``(K,)``-swept, as in the 'xk' layout.

The noisy years of the fused ``transitions`` engine are keyword modes, as in
JAX ``pallas_miz_year`` (``pallas_year.py:925-928``; :mod:`._year`):
``noise=`` a ``(nt, K)`` per-step offset table (K5), ``noise_ou=(rho,
scale, eta0)`` the OU recurrence over that table as white noise, returning
the year-end ``eta`` (K6), ``noise_keys=`` ``(K, 2)`` uint32 keys whose
float32 draws the kernel makes itself (K7), ``ou_assoc=True`` the log-depth
OU path (K8), and ``crossing=(thr, sign)``, the first step whose ice area
crosses (K9).

Counters: ``miz_year.launches`` (every launch) and
``miz_year.newton_updates``, the members' Newton updates as the kernel ran
them, fed by every launch given ``newton_iters=``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..models.base import StepConfig
from ..solutions import Seasonal
from ..utils.collection import Collection
from ..utils.numerics import host_cos
from ..utils.tracing import traced
from . import _build
from ._year import (FORCE_CLUSTER, WIDE, CrossingTracker, NoiseLaunch, check_crossing_args,
                    check_noise_args, check_raw_fits, check_width, check_year_args,
                    cluster_plan, member_columns, noise_offsets, pcr_shared_bytes, refuse_grad,
                    workspace, year_result, year_tables)
from .diffusion import diffusion_bands
from .tridiag import pcr_steps

__all__ = ["miz_year", "miz_year_reference", "member_params", "check_nx", "MAX_NX",
           "CARRY_KEYS", "OUT_VARS", "PAR_NAMES", "XK_TABLE_ROWS", "ROW_NAMES"]

# carry fields of the MIZ model (models/miz.py init_carry)
CARRY_KEYS = ("Ei", "Ew", "h", "D", "phi", "T0")
# recorded solution variables, in ModelSpec order
OUT_VARS = ("E", "T", "h", "Ei", "Ew", "Ti", "Tw", "D", "phi", "n")
# physical parameters the step reads, one column each of the member stack
PAR_NAMES = (
    "k", "Tm", "A", "B", "ai", "Fb", "cw", "m1",
    "Lf", "alpha", "rl", "Dmin", "Dmax", "hmin", "kappa", "D",
)
# parameters of the insolation/coalbedo rebuild (S0 - (S1 x) cos) - S2 x^2
# and a0 - a2 x^2
XK_TABLE_ROWS = ("S0", "S1", "S2", "a0", "a2")
# the (K, 23) stack: PAR_NAMES, the hoisted Tm^m2, the virtual "F" forcing
# offset, then the table parameters (JAX pallas_year.py:102-119, :901-908)
ROW_NAMES = PAR_NAMES + ("Tm_pow_m2", "F") + XK_TABLE_ROWS
# up to 1024 cells in registers (one per thread), above that the cluster
# build (a thread-block cluster per member)
MAX_NX = WIDE["miz_year"]["max"]


def member_params(par, K: int, dtype, device, zero=0.0) -> torch.Tensor:
    """The ``(K, len(ROW_NAMES))`` per-member parameter stack of the kernel
    (leaves and ``zero`` as in :func:`._year.member_columns`)."""
    cols = member_columns(par, PAR_NAMES + XK_TABLE_ROWS + ("m2",), K, dtype, device, zero)
    # Tm^m2 of wlat, computed here once (models/miz.py statics)
    cols["Tm_pow_m2"] = cols["Tm"] ** cols["m2"]
    return torch.stack([cols[n] for n in ROW_NAMES], dim=1).contiguous()


def check_nx(nx: int) -> None:
    """Raise ``ValueError`` when the kernel cannot run an ``nx``-cell grid."""
    check_width("miz_year", nx)


def _host_tables(st, dtype):
    """Per-cell columns ``(5, nx)`` — x, x^2 and the stencil bands
    glo/gdi/gup — and the ``(nt,)`` table of cos(2 pi t), built on the host
    with the values of JAX ``pallas_year.py:1191-1193`` (copied to the device
    once by :func:`._year.year_tables`)."""
    x = torch.as_tensor(st.x, dtype=dtype)
    t = torch.as_tensor(st.t, dtype=dtype)
    geom = diffusion_bands(st)
    band = lambda b: torch.as_tensor(np.asarray(b), dtype=dtype)
    cols = torch.stack([x, x * x, band(geom.lo), band(geom.di), band(geom.up)])
    return cols, host_cos(2.0 * math.pi * t)


@traced("ebm.year.miz")
def miz_year(carry, par, fyear, st, cfg: StepConfig, collect_raw: bool = False,
             noise=None, noise_ou=None, noise_keys=None, ou_assoc: bool = False,
             crossing=None, newton_iters=None):
    """Run one MIZ model year for a ``(K, nx)`` ensemble.

    ``(carry, par, fyear) -> (carry, Seasonal, converged, raw)``, as JAX
    ``pallas_miz_year``: ``carry`` holds the six ``(K, nx)`` fields of
    ``CARRY_KEYS``; ``par`` leaves are scalars or ``(K,)``; ``fyear`` is the
    ``(nt,)`` shared forcing row; the seasonal Collections hold ``(K, nx)``
    tensors; ``converged`` is a 0-dim tensor, 1.0 when every Newton solve of
    every member converged. ``raw`` is None, or with ``collect_raw`` a
    Collection of every step's outputs, ``(nt, K, nx)`` per variable.
    With ``noise_ou`` the fourth result is the year-end ``(K,)`` OU value
    instead, and with ``crossing`` a fifth holds each member's first
    crossing step (-1 where none), as JAX ``pallas_miz_year`` returns them.

    ``newton_iters``, a ``(K,)`` int32 CUDA tensor, receives each member's
    number of Newton updates in the year, as the kernel ran them (its
    operation count), and their sum is added to ``miz_year.newton_updates``
    (read back after the launch: a sync); the plain version iterates in
    lockstep over all members and has no such count, so it raises. A
    launch without ``newton_iters`` counts nothing and does not sync.

    On a CUDA device this launches the kernel (counted in
    ``miz_year.launches``; above nx = 1024 its cluster build) and raises if
    it cannot (``nx > MAX_NX``, or a cluster build the card cannot launch);
    on the CPU it runs :func:`miz_year_reference`. Under ``torch.profiler``
    the whole call is the span ``ebm.year.miz`` (:mod:`..utils.tracing`).
    """
    K, nx, dtype, device = check_year_args(carry, CARRY_KEYS, fyear, st, "miz_year")
    noise_kw = dict(noise=noise, noise_ou=noise_ou, noise_keys=noise_keys,
                    ou_assoc=ou_assoc, crossing=crossing)
    if device.type == "cuda":
        refuse_grad("miz_year", carry, par, fyear, noise, noise_ou)
        check_noise_args(dtype, noise, noise_ou, noise_keys, ou_assoc, collect_raw)
        check_crossing_args(crossing, noise_keys, noise_ou)
        if newton_iters is not None and not (
                newton_iters.dtype == torch.int32 and newton_iters.shape == (K,)
                and newton_iters.device == device and newton_iters.is_contiguous()):
            raise ValueError(
                f"newton_iters must be a contiguous ({K},) int32 tensor on {device}")
        out = _year_cuda(carry, par, fyear, st, cfg, collect_raw, newton_iters=newton_iters,
                         **noise_kw)
        if newton_iters is not None:
            _build.count(miz_year, "newton_updates", int(newton_iters.sum()))
        return out
    if device.type == "cpu":
        if newton_iters is not None:
            raise ValueError("newton_iters is counted by the kernel only: the plain version "
                             "runs its Newton loop in lockstep over all members")
        return miz_year_reference(carry, par, fyear, st, cfg, collect_raw, **noise_kw)
    raise ValueError(f"miz_year has no kernel for device {device}")


miz_year.launches = 0
miz_year.newton_updates = 0


def miz_year_reference(carry, par, fyear, st, cfg: StepConfig,
                       collect_raw: bool = False, noise=None, noise_ou=None,
                       noise_keys=None, ou_assoc: bool = False, crossing=None):
    """The plain PyTorch version of :func:`miz_year` on any device: the scan
    engine's loop over the ``nt`` steps of ``models.miz.step`` on ``(K, nx)``
    tensors, with every parameter as a ``(K, 1)`` column and the forcing
    ``(fyear[t] + F) + offset`` added in the run's dtype, as the kernel adds
    it (the offset from :func:`._year.noise_offsets`; the crossing detector
    is a step hook). Its Newton loop runs in lockstep over all members, like
    the JAX package's XLA path; the kernel's runs per member. The two agree
    to below the Newton tolerance (JAX ``pallas_year.py:19-23``)."""
    # imported here: integrate.py imports this module
    from ..integrate import make_year_fn

    K, nx, dtype, device = check_year_args(carry, CARRY_KEYS, fyear, st, "miz_year")
    check_noise_args(dtype, noise, noise_ou, noise_keys, ou_assoc, collect_raw)
    check_crossing_args(crossing, noise_keys, noise_ou)
    cols = member_columns(par, PAR_NAMES + XK_TABLE_ROWS + ("m2",), K, dtype, device)
    f = torch.as_tensor(fyear, dtype=dtype, device=device)
    f_rows = f[:, None] + cols.pop("F")[None, :]  # (nt, K)
    eta = None
    if noise is not None or noise_keys is not None:
        offsets, eta = noise_offsets(noise, noise_ou, noise_keys, ou_assoc, K, st.nt, dtype,
                                     device)
        f_rows = f_rows + offsets
    tracker = (CrossingTracker("MIZ", crossing, st, K, dtype, device)
               if crossing is not None else None)
    year = make_year_fn("MIZ", st, dataclasses.replace(cfg, solver="pcr"), collect_raw,
                        tracker)
    out = year(Collection({k: carry[k] for k in CARRY_KEYS}),
               Collection({n: v[:, None] for n, v in cols.items()}), f_rows[:, :, None])
    return year_result(out, noise_ou, eta, tracker.first if tracker is not None else None)


def _year_cuda(carry, par, fyear, st, cfg, collect_raw, noise, noise_ou, noise_keys, ou_assoc,
               crossing, newton_iters):
    K, nx = carry["Ei"].shape
    dtype, device = carry["Ei"].dtype, carry["Ei"].device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the miz_year kernel takes float32 or float64, got {dtype}")
    check_nx(nx)
    # the grid's tables on the device, built once (a forcing row already on
    # the device takes no copy either)
    tables = year_tables("miz_year", st, dtype, device, _host_tables)
    pars = member_params(par, K, dtype, device, tables.zero)
    f = torch.as_tensor(fyear, dtype=dtype, device=device).contiguous()
    # csrc/miz_year.cu::base_shared_bytes: the PCR buffers, the neighbour
    # exchange, two sets of reduction slots (the cluster build's plan counts
    # its own: a slice of each per block)
    size = pars.element_size()
    rows = (0 if nx > WIDE["miz_year"]["narrow"]
            else pcr_shared_bytes(nx, pcr_steps(nx), size) + 4 * size * (nx + 2))
    nz = NoiseLaunch(noise, noise_ou, noise_keys, ou_assoc, crossing, st, K, dtype, device,
                     rows + 128 * size, tables.weights)
    if collect_raw:
        check_raw_fits(st.nt, len(OUT_VARS), K, nx, dtype, device)
    cols, cosv = tables.cols, tables.cos
    cin = torch.stack([carry[k] for k in CARRY_KEYS])  # (6, K, nx), contiguous
    cout = torch.empty((len(CARRY_KEYS), K, nx), dtype=dtype, device=device)
    wint, summ, avg = (
        torch.empty((len(OUT_VARS), K, nx), dtype=dtype, device=device)
        for _ in range(3)
    )
    conv = torch.empty((K,), dtype=dtype, device=device)
    # every step's outputs, (nt, 10, K, nx), or a null pointer
    raw = (torch.empty((st.nt, len(OUT_VARS), K, nx), dtype=dtype, device=device)
           if collect_raw else None)
    # above the register builds' width, the cluster build as the C side
    # plans it (it launches with the same plan), with a workspace only where
    # its records stay in device memory
    plan = (cluster_plan("miz_year", nx, st.nt, K, dtype, device, nz.noisy, nz.ou_mode,
                         newton_iters is not None)
            if nx > WIDE["miz_year"]["narrow"] else None)
    ws, ws_ptr, ws_words, ws_blocks = workspace("miz_year", nx, K, dtype, device, plan)
    ptrs = [v.data_ptr() for v in (cin, pars, cols, cosv, f, cout, wint, summ, avg, conv)]
    ptrs += [v.data_ptr() if v is not None else None for v in (newton_iters, raw)]
    max_step = cfg.newton_max_step if cfg.newton_max_step is not None else math.inf
    _build.launch("ebm_miz_year", dtype, device, *ptrs, *nz.ptrs, ws_ptr, K, nx, st.nt,
                  st.winter_inx - 1, st.summer_inx - 1, pcr_steps(nx), cfg.newton_max_iter,
                  nz.ou_mode, nz.unroll, ws_words, ws_blocks, FORCE_CLUSTER["miz_year"], st.dt,
                  cfg.newton_abstol, cfg.newton_reltol, max_step)
    _build.count(miz_year)
    new_carry = Collection({k: cout[j] for j, k in enumerate(CARRY_KEYS)})
    seasonal = Seasonal(
        *(Collection({k: store[i] for i, k in enumerate(OUT_VARS)})
          for store in (wint, summ, avg))
    )
    if raw is not None:
        raw = Collection({k: raw[:, i] for i, k in enumerate(OUT_VARS)})
    return year_result((new_carry, seasonal, conv.min(), raw), noise_ou, nz.eta, nz.first)
