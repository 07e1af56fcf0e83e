"""Fused whole-year Classic (WE15) integration: the wrapper of the CUDA
kernel ``csrc/classic_year.cu`` and its plain PyTorch version.

Port of the JAX package's ``ops/pallas_year.py::pallas_classic_year`` (its
'xk' launcher ``_classic_year_xk`` and its 'kx' branch): one call runs all
``nt`` steps of a model year for a ``(K, nx)`` ensemble, with the implicit
``Tg`` solve by PCR inside, and builds the seasonal store (winter/summer
snapshots at the tick indices, annual sums divided by ``nt`` at the end) as
it goes; on request it also stores every step's outputs (a raw-collected
year).

:func:`classic_year` dispatches on the device of the carry: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs the plain version
:func:`classic_year_reference`, the scan engine's year loop
(:func:`..integrate.make_year_fn`) on per-member parameter columns. Every
parameter may be ``(K,)``-swept, the insolation and coalbedo parameters
``S0, S1, S2, a0, a2`` included, as in the 'xk' layout. The kernel takes the
per-member scalars from :func:`..models.classic.member_scalars`, the code
the plain version's statics run, so the two see the same operands.

The kernel has two layouts of one step (``csrc/classic_year.cu``): one
member per warp for grids of ``nx <= 256`` and ``K >= WARP_MIN_K``, one
thread block per member otherwise; both compute every value by the same
operations as the plain version, so the choice changes no bit. Above nx =
4096 a cluster build runs a member on a cluster of blocks and solves Tg by
chunks (:func:`.tridiag.chunked_solve`), as the plain version does there.

The noisy years take the keyword modes of :func:`.miz_year.miz_year`
(``noise=``, ``noise_ou=``, ``noise_keys=``, ``ou_assoc=``, ``crossing=``;
JAX ``pallas_classic_year``); the Classic crossing area is ``sum_i w_i
[E_i < 0]`` of the step's updated ``E`` (JAX ``pallas_year.py:1738-1747``),
and the serial OU recurrence contracts as XLA:CPU contracts the JAX Classic
kernel's unrolled time loop (:func:`._year.ou_path`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.base import StepConfig
from ..models.classic import cos_table, member_scalars, uniform_bands
from ..solutions import Seasonal
from ..utils.collection import Collection
from ..utils.tracing import traced
from . import _build
from ._year import (FORCE_CLUSTER, WIDE, CrossingTracker, NoiseLaunch, check_crossing_args,
                    check_noise_args, check_raw_fits, check_width, check_year_args,
                    classic_ou_unroll, cluster_plan, member_columns, noise_offsets,
                    pcr_shared_bytes, refuse_grad, workspace, year_result, year_tables)
from .tridiag import chunk_count, pcr_steps

__all__ = ["classic_year", "classic_year_reference", "member_params", "check_nx",
           "MAX_NX", "WARP_MIN_K", "CARRY_KEYS", "OUT_VARS", "PAR_NAMES", "ROW_NAMES"]

# carry fields and recorded variables (models/classic.py)
CARRY_KEYS = ("E", "Tg")
OUT_VARS = ("E", "T", "h")
# the physical parameters of models/classic.py, one column each
PAR_NAMES = ("cg", "tau", "B", "k", "Lf", "D", "ai", "A", "Fb", "cw",
             "S0", "S1", "S2", "a0", "a2")
# the (K, 18) stack the kernel reads (csrc/classic_year.cu enum Row): the
# statics' scalar combinations, the band scale dt*D, the parameters the step
# reads, the virtual "F" forcing offset and the table parameters
ROW_NAMES = ("cg_tau", "dt_tau", "dc", "M", "kLf", "dtD", "cg", "ai", "A", "Fb", "cw",
             "Lf", "F", "S0", "S1", "S2", "a0", "a2")
# up to 4096 cells in registers (at most 4 per thread of 1024), above that
# the cluster build (a thread-block cluster per member)
MAX_NX = WIDE["classic_year"]["max"]
# the least K that runs a grid of nx <= 256 on the kernel's warp builds (one
# member per warp, csrc/classic_year.cu); a smaller K runs the block build,
# whose one member per block is faster while it needs few rounds of resident
# blocks. On an H100 (canonical grid, float32; chip_smoke.py phase 10) a year
# took 8.9 ms on the block build and 24.4 on the warp build at K = 1, and
# the two met at K = 1535-1536 (27.4-28.0 ms both)
WARP_MIN_K = 1536


def member_params(par, K: int, dt, dtype, device, zero=0.0) -> torch.Tensor:
    """The ``(K, len(ROW_NAMES))`` per-member stack of the kernel. Each leaf
    of ``par`` is a scalar or ``(K,)``; ``"F"`` is optional (``zero`` when
    absent, as in :func:`._year.member_columns`). ``dt`` is a float or a
    0-dim tensor of the run's dtype on ``device``."""
    cols = member_columns(par, PAR_NAMES, K, dtype, device, zero)
    cols.update(member_scalars(cols, torch.as_tensor(dt, dtype=dtype, device=device)))
    return torch.stack([cols[n] for n in ROW_NAMES], dim=1).contiguous()


def _host_tables(st, dtype):
    """The per-cell columns ``(5, nx)`` (x, x^2 and the uniform-grid bands)
    and the ``(nt + 1,)`` cos table, on the host (:func:`._year.year_tables`)."""
    x = torch.as_tensor(st.x, dtype=dtype)
    geom = uniform_bands(st.nx)
    band = lambda b: torch.as_tensor(np.asarray(b), dtype=dtype)
    cols = torch.stack([x, x * x, band(geom.lo), band(geom.di), band(geom.up)])
    return cols, cos_table(st, dtype)


def check_nx(nx: int) -> None:
    """Raise ``ValueError`` when the kernel cannot run an ``nx``-cell grid."""
    check_width("classic_year", nx)


@traced("ebm.year.classic")
def classic_year(carry, par, fyear, st, cfg: StepConfig, collect_raw: bool = False,
                 noise=None, noise_ou=None, noise_keys=None, ou_assoc: bool = False,
                 crossing=None):
    """Run one Classic model year for a ``(K, nx)`` ensemble.

    ``(carry, par, fyear) -> (carry, Seasonal, None, raw)``, as JAX
    ``pallas_classic_year``: ``carry`` holds ``E`` and ``Tg``, ``(K, nx)``
    each; ``par`` leaves are scalars or ``(K,)``; ``fyear`` is the ``(nt,)``
    shared forcing row; the seasonal Collections hold ``(K, nx)`` tensors.
    The step has no Newton solve, so there is no convergence flag. ``raw``
    is None, or with ``collect_raw`` a Collection of every step's outputs,
    ``(nt, K, nx)`` per variable. ``cfg`` is accepted for the interface of
    the fused engine: the kernel always solves ``Tg`` by PCR. The noise
    modes return as :func:`.miz_year.miz_year`'s do.

    On a CUDA device this launches the kernel (counted in
    ``classic_year.launches``; above nx = 4096 its cluster build, which
    solves Tg by chunks, counted in ``classic_year.chunked_launches`` too)
    and raises
    if it cannot (``nx > MAX_NX``, or a cluster build the card cannot
    launch); on the CPU it runs
    :func:`classic_year_reference`. Under ``torch.profiler`` the whole call
    is the span ``ebm.year.classic`` (:mod:`..utils.tracing`).
    """
    K, nx, dtype, device = check_year_args(carry, CARRY_KEYS, fyear, st, "classic_year")
    noise_kw = dict(noise=noise, noise_ou=noise_ou, noise_keys=noise_keys,
                    ou_assoc=ou_assoc, crossing=crossing)
    if device.type == "cuda":
        refuse_grad("classic_year", carry, par, fyear, noise, noise_ou)
        check_noise_args(dtype, noise, noise_ou, noise_keys, ou_assoc, collect_raw)
        check_crossing_args(crossing, noise_keys, noise_ou)
        return _year_cuda(carry, par, fyear, st, collect_raw, **noise_kw)
    if device.type == "cpu":
        return classic_year_reference(carry, par, fyear, st, cfg, collect_raw, **noise_kw)
    raise ValueError(f"classic_year has no kernel for device {device}")


classic_year.launches = 0
classic_year.chunked_launches = 0


def classic_year_reference(carry, par, fyear, st, cfg: StepConfig,
                           collect_raw: bool = False, noise=None, noise_ou=None,
                           noise_keys=None, ou_assoc: bool = False, crossing=None):
    """The plain PyTorch version of :func:`classic_year` on any device: the
    scan engine's loop over the ``nt`` steps of ``models.classic.step`` on
    ``(K, nx)`` tensors, with every parameter as a ``(K, 1)`` column, the
    forcing ``(fyear[t] + F) + offset`` added in the run's dtype as the
    kernel adds it, and the ``Tg`` solve by PCR (above nx = 4096, where the
    kernel runs its cluster build, by chunks: :func:`.tridiag.chunked_solve`)."""
    # imported here: integrate.py imports this module
    from ..integrate import make_year_fn

    K, nx, dtype, device = check_year_args(carry, CARRY_KEYS, fyear, st, "classic_year")
    check_noise_args(dtype, noise, noise_ou, noise_keys, ou_assoc, collect_raw)
    check_crossing_args(crossing, noise_keys, noise_ou)
    cols = member_columns(par, PAR_NAMES, K, dtype, device)
    f = torch.as_tensor(fyear, dtype=dtype, device=device)
    f_rows = f[:, None] + cols.pop("F")[None, :]  # (nt, K)
    eta = None
    if noise is not None or noise_keys is not None:
        offsets, eta = noise_offsets(noise, noise_ou, noise_keys, ou_assoc, K, st.nt, dtype,
                                     device, unroll=classic_ou_unroll(st.nt))
        f_rows = f_rows + offsets
    tracker = (CrossingTracker("Classic", crossing, st, K, dtype, device)
               if crossing is not None else None)
    solver = "chunked" if nx > WIDE["classic_year"]["narrow"] else "pcr"
    year = make_year_fn("Classic", st, dataclasses.replace(cfg, solver=solver), collect_raw,
                        tracker)
    out = year(Collection({k: carry[k] for k in CARRY_KEYS}),
               Collection({n: v[:, None] for n, v in cols.items()}), f_rows[:, :, None])
    return year_result(out, noise_ou, eta, tracker.first if tracker is not None else None)


def _year_cuda(carry, par, fyear, st, collect_raw, noise, noise_ou, noise_keys, ou_assoc,
               crossing):
    K, nx = carry["E"].shape
    dtype, device = carry["E"].dtype, carry["E"].device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the classic_year kernel takes float32 or float64, got {dtype}")
    check_nx(nx)
    # the PCR buffers and the crossing sum's slots (csrc/classic_year.cu; the
    # cluster build's plan counts its own: a slice of the rows per block)
    size = torch.empty((), dtype=dtype).element_size()
    rows = 0 if nx > WIDE["classic_year"]["narrow"] else pcr_shared_bytes(nx, pcr_steps(nx),
                                                                          size)
    # the grid's tables on the device, built once (a forcing row already on
    # the device takes no copy either)
    tables = year_tables("classic_year", st, dtype, device, _host_tables)
    nz = NoiseLaunch(noise, noise_ou, noise_keys, ou_assoc, crossing, st, K, dtype, device,
                     rows + 64 * size, tables.weights, unroll=classic_ou_unroll(st.nt))
    if collect_raw:
        check_raw_fits(st.nt, len(OUT_VARS), K, nx, dtype, device)
    pars = member_params(par, K, tables.dt, dtype, device, tables.zero)
    cols, cosv = tables.cols, tables.cos
    f = torch.as_tensor(fyear, dtype=dtype, device=device).contiguous()
    cin = torch.stack([carry[k] for k in CARRY_KEYS])  # (2, K, nx), contiguous
    cout = torch.empty((len(CARRY_KEYS), K, nx), dtype=dtype, device=device)
    wint, summ, avg = (
        torch.empty((len(OUT_VARS), K, nx), dtype=dtype, device=device)
        for _ in range(3)
    )
    # every step's outputs, (nt, 3, K, nx), or a null pointer
    raw = (torch.empty((st.nt, len(OUT_VARS), K, nx), dtype=dtype, device=device)
           if collect_raw else None)
    # above the register builds' width, the cluster build as the C side
    # plans it (it launches with the same plan), with a workspace only where
    # its records stay in device memory
    plan = (cluster_plan("classic_year", nx, st.nt, K, dtype, device, nz.noisy, nz.ou_mode)
            if nx > WIDE["classic_year"]["narrow"] else None)
    ws, ws_ptr, ws_words, ws_blocks = workspace("classic_year", nx, K, dtype, device, plan)
    # the PCR's levels: of the whole system, or of the cluster build's
    # interface system (two rows a chunk)
    steps = pcr_steps(nx if plan is None else 2 * chunk_count(nx))
    ptrs = [v.data_ptr() for v in (cin, pars, cols, cosv, f, cout, wint, summ, avg)]
    ptrs.append(raw.data_ptr() if raw is not None else None)
    _build.launch("ebm_classic_year", dtype, device, *ptrs, *nz.ptrs, ws_ptr, K, nx, st.nt,
                  st.winter_inx - 1, st.summer_inx - 1, steps, nz.ou_mode, nz.unroll,
                  WARP_MIN_K, ws_words, ws_blocks, FORCE_CLUSTER["classic_year"], st.dt)
    _build.count(classic_year)
    if plan is not None:
        _build.count(classic_year, "chunked_launches")
    new_carry = Collection({k: cout[j] for j, k in enumerate(CARRY_KEYS)})
    seasonal = Seasonal(
        *(Collection({k: store[i] for i, k in enumerate(OUT_VARS)})
          for store in (wint, summ, avg))
    )
    if raw is not None:
        raw = Collection({k: raw[:, i] for i, k in enumerate(OUT_VARS)})
    return year_result((new_carry, seasonal, None, raw), noise_ou, nz.eta, nz.first)
