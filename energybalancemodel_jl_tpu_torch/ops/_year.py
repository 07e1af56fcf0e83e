"""Argument handling shared by the whole-year kernel wrappers
(:mod:`.miz_year`, :mod:`.classic_year`), and the noise modes of their plain
versions.

The noise modes are those of the JAX package's whole-year kernels
(``ops/pallas_year.py:925-928``): a per-step per-member forcing offset
table (``noise=``), the OU recurrence over a white table (``noise_ou=``),
white draws made from per-member keys (``noise_keys=``), the log-depth OU
path (``ou_assoc=True``), and the first step whose instantaneous ice area
crosses a per-member threshold (``crossing=``). The TPU padding helpers of
the JAX module have no counterpart: a block per member pads nothing.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from . import prng
from .tridiag import CHUNK

__all__ = ["member_columns", "check_year_args", "check_width", "check_noise_args",
           "check_crossing_args", "trapezoid_weights", "ou_path", "assoc_ou_path",
           "classic_ou_unroll", "noise_offsets", "member_rows", "keys_tensor",
           "block_sum", "block_layout", "pcr_shared_bytes", "CrossingTracker", "NoiseLaunch",
           "year_result", "MAX_SHARED_BYTES", "refuse_grad", "WIDE",
           "FORCE_CLUSTER", "ClusterPlan", "cluster_plan", "wide_workspace", "wide_words",
           "workspace", "check_raw_fits", "YearTables", "year_tables", "clear_year_tables",
           "YEAR_TABLES_MAX", "year_keys"]


def refuse_grad(kernel: str, *values) -> None:
    """Raise ``ValueError`` when any tensor among ``values`` (tensors,
    Collections or dicts of them, tuples, scalars) requires grad while grad
    mode is on: the CUDA kernels have no VJP, and their wrappers return
    tensors with no ``grad_fn``, so a loss built on them would silently lose
    its gradient (the JAX package fails the same way: ``pallas_call`` has no
    VJP). Every kernel wrapper calls it before a launch."""
    if not torch.is_grad_enabled():
        return

    def tensors(v):
        if torch.is_tensor(v):
            yield v
        elif isinstance(v, dict):
            for x in v.values():
                yield from tensors(x)
        elif isinstance(v, (tuple, list)):
            for x in v:
                yield from tensors(x)

    if any(t.requires_grad for v in values for t in tensors(v)):
        raise ValueError(
            f"the {kernel} kernel has no gradient, and an input requires grad: "
            "differentiate the eager year instead (engine='batched' with "
            "solver='pcr', or the scan engine of integrate)")


def member_columns(par, names, K: int, dtype, device, zero=0.0):
    """name -> ``(K,)`` tensor for each of ``names`` and the virtual ``"F"``
    forcing offset. Each leaf of ``par`` is a scalar (shared) or has shape
    ``(K,)`` (swept); ``"F"`` is optional (a per-member constant added to the
    forcing, ``zero`` when absent: 0, or a 0-dim 0 on the device such as
    :attr:`YearTables.zero`, which takes no copy)."""
    cols = {n: _member_col(par[n], K, dtype, device) for n in names}
    cols["F"] = _member_col(par.get("F", zero), K, dtype, device)
    return cols


def _member_col(v, K: int, dtype, device):
    v = torch.as_tensor(v, dtype=dtype, device=device)
    if v.ndim == 0:
        return v.expand(K)
    v = v.reshape(-1)
    if v.shape[0] != K:
        raise ValueError(
            f"swept parameter leaves must have shape ({K},), got {tuple(v.shape)}"
        )
    return v


def member_rows(values, K: int, dtype, device) -> torch.Tensor:
    """``(K, len(values))``: each value a scalar or ``(K,)``, one column
    each (the OU and crossing rows of the kernels)."""
    return torch.stack([_member_col(v, K, dtype, device) for v in values], dim=1).contiguous()


def check_year_args(carry, keys, fyear, st, what: str):
    """Check a year's ``(K, nx)`` carry (every field of ``keys`` with one
    shape, dtype and device, on ``st``'s grid) and its ``(nt,)`` forcing
    row; returns ``(K, nx, dtype, device)``."""
    first = carry[keys[0]]
    if first.ndim != 2:
        raise ValueError(f"{what} takes a (K, nx) carry, got shape {tuple(first.shape)}")
    K, nx = first.shape
    if nx != st.nx:
        raise ValueError(f"carry has nx={nx} but the SpaceTime has nx={st.nx}")
    for k in keys:
        v = carry[k]
        if v.shape != first.shape or v.dtype != first.dtype or v.device != first.device:
            raise ValueError(
                f"carry[{k!r}] is {v.dtype} {tuple(v.shape)} on {v.device}; "
                f"expected {first.dtype} {tuple(first.shape)} on {first.device}"
            )
    if tuple(np.shape(fyear)) != (st.nt,):
        raise ValueError(f"fyear must have shape ({st.nt},), got {tuple(np.shape(fyear))}")
    return K, nx, first.dtype, first.device


def check_width(kernel: str, nx: int) -> None:
    """Raise ``ValueError`` when a grid is wider than the kernel's wide build
    runs (:data:`WIDE`)."""
    top = WIDE[kernel]["max"]
    if nx > top:
        raise ValueError(
            f"the {kernel} kernel runs nx <= {top}: its wide build is built and held "
            f"against its plain version up to that width; nx={nx} is wider"
        )


def check_noise_args(dtype, noise, noise_ou, noise_keys, ou_assoc, collect_raw=False):
    """The noise-mode argument checks of the whole-year wrappers, with the
    JAX package's messages (``pallas_year.py:211-241``). A raw-collected
    year takes no noise (its fourth result is the raw store, a noisy
    year's is the year-end OU value)."""
    if noise is not None and noise_keys is not None:
        raise ValueError(
            "noise= (explicit table) and noise_keys= (in-kernel "
            "generation) are mutually exclusive")
    if noise_keys is not None and dtype != torch.float32:
        raise ValueError(
            "noise_keys generates float32 draws (the jax.random.normal "
            "f32 pipeline); run the ensemble in float32 or pass an "
            "explicit noise= table")
    if noise_ou is not None and noise is None and noise_keys is None:
        raise ValueError(
            "noise_ou requires the white-noise table (noise=) or "
            "in-kernel generation keys (noise_keys=)")
    if noise_keys is not None and noise_ou is None:
        raise ValueError(
            "noise_keys= requires noise_ou= (the JAX kernels keep padded "
            "lanes deterministic through the OU scale); for plain "
            "white-noise offsets pass an explicit noise= table")
    if ou_assoc and (noise_ou is None or noise_keys is None):
        raise ValueError(
            "ou_assoc=True precomputes the OU path over the generated "
            "scratch — it requires noise_keys= and noise_ou=")
    if collect_raw and (noise is not None or noise_keys is not None):
        raise ValueError("a raw-collected year takes no noise= or noise_keys=")


def check_crossing_args(crossing, noise_keys, noise_ou) -> None:
    """JAX ``pallas_year.py:244-254``."""
    if crossing is None:
        return
    if noise_keys is None or noise_ou is None:
        raise ValueError(
            "crossing= (in-kernel first-crossing detection) is only "
            "wired through the generating OU kernels; it requires "
            "noise_keys= and noise_ou=")
    if len(crossing) != 2:
        raise ValueError("crossing must be (threshold, sign) per-member rows")


def trapezoid_weights(x, dtype, device=None) -> torch.Tensor:
    """Per-cell weights ``w`` with ``sum_i w_i v_i`` the trapezoid integral
    ``sum_i (v_i + v_{i+1}) (x_{i+1} - x_i) / 2`` up to summation order:
    ``w_0 = dx_0/2, w_i = (dx_{i-1} + dx_i)/2, w_{nx-1} = dx_{nx-2}/2``, in
    float64 and then cast (JAX ``pallas_year.py:194-208``)."""
    x = np.asarray(x, dtype=np.float64)
    dx = np.diff(x)
    w = np.zeros(x.shape[0], dtype=np.float64)
    w[0] = dx[0] / 2.0
    w[1:-1] = (dx[:-1] + dx[1:]) / 2.0
    w[-1] = dx[-1] / 2.0
    return torch.as_tensor(w, dtype=dtype, device=device)


class YearTables(NamedTuple):
    """The inputs of a year kernel that the grid, the dtype and the device
    fix, on the device: the ``(5, nx)`` per-cell columns (``x``, ``x^2`` and
    the three diffusion bands), the kernel's ``cos(2 pi t)`` table, ``dt``
    and the default ``"F"`` offset 0 as 0-dim tensors, and the crossing
    sum's trapezoid weights (None on a grid of one cell, which has no
    area)."""
    cols: torch.Tensor
    cos: torch.Tensor
    dt: torch.Tensor
    zero: torch.Tensor
    weights: torch.Tensor | None


# the entries the year-table cache keeps; past them the least recently used
# goes (a grid of nx = 32768 in float64 holds about 1.6 MB)
YEAR_TABLES_MAX = 16
_TABLES: collections.OrderedDict = collections.OrderedDict()
_TABLES_LOCK = threading.Lock()


def year_tables(kernel: str, st, dtype, device, build) -> YearTables:
    """``kernel``'s :class:`YearTables` for grid ``st`` in ``dtype`` on
    ``device``, copied to the device once and then reused, so that a year
    launch copies nothing from the host. ``build(st, dtype)`` makes the
    columns and the ``cos`` table on the host (where the kernel's values come
    from: a device's ``cos`` may round differently).

    An entry is keyed by what sets its values: the kernel, the grid's
    defining fields (map, range, ``nx``; ``nt``, which sets ``t`` and
    ``dt``), the dtype and the device, so a mesh's shards on other devices
    get entries of their own. ``year_tables.builds`` counts the entries
    built, ``year_tables.hits`` the lookups that found one."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (kernel, st.grid, tuple(st.urange), st.nx, st.nt, dtype, device)
    with _TABLES_LOCK:
        tables = _TABLES.get(key)
        if tables is None:
            cols, cosv = build(st, dtype)
            put = lambda v: torch.as_tensor(v, dtype=dtype, device=device).contiguous()
            tables = YearTables(put(cols), put(cosv), put(st.dt), put(0.0),
                                trapezoid_weights(st.x, dtype, device) if st.nx > 1 else None)
            _TABLES[key] = tables
            while len(_TABLES) > YEAR_TABLES_MAX:
                _TABLES.popitem(last=False)
            year_tables.builds += 1
        else:
            _TABLES.move_to_end(key)
            year_tables.hits += 1
    if device.type == "cuda":
        # a mesh's shards launch on streams of their own: an entry dropped
        # later is then reused only after their kernels have read it
        stream = torch.cuda.current_stream(device)
        for v in tables:
            if v is not None:
                v.record_stream(stream)
    return tables


year_tables.builds = 0
year_tables.hits = 0


def clear_year_tables() -> None:
    """Drop every entry of the year-table cache (the counters stay)."""
    with _TABLES_LOCK:
        _TABLES.clear()


def _fma(dtype):
    return prng.fma_f32 if dtype == torch.float32 else prng.fma_f64


def ou_path(xi, rho, scale, eta0, unroll: int = 1) -> torch.Tensor:
    """The serial OU recurrence over the rows of a ``(nt, K)`` white table
    from ``eta0``: ``eta_t = fma(rho, eta_{t-1}, scale * xi_t)``, the
    contraction XLA makes of ``rho * eta + scale * xi`` (JAX
    ``stochastic.py:294-296``, ``pallas_year.py:588``) and the kernels' own.
    With ``unroll = u > 1`` only steps ``t % u == 0`` contract so, the others
    as ``fma(scale, xi_t, rho * eta_{t-1})``: how XLA:CPU evaluates the JAX
    Classic kernel, whose time loop is unrolled ``u``-fold
    (``pallas_year.py:49-89``; :func:`classic_ou_unroll`). ``rho``,
    ``scale``, ``eta0`` are scalars or ``(K,)``; returns the ``(nt, K)``
    path."""
    fma = _fma(xi.dtype)
    K = xi.shape[1]
    rho, scale, eta = (_member_col(v, K, xi.dtype, xi.device) for v in (rho, scale, eta0))
    rows = []
    for t in range(xi.shape[0]):
        if t % unroll == 0:
            eta = fma(rho, eta, scale * xi[t])
        else:
            eta = fma(scale, xi[t], rho * eta)
        rows.append(eta)
    return torch.stack(rows)


def classic_ou_unroll(nt: int) -> int:
    """The unroll of the JAX Classic kernel's time loop: the largest power of
    two up to 8 that divides ``nt`` (JAX ``pallas_year.py:49-73``)."""
    u = 8
    while nt % u:
        u //= 2
    return u


def assoc_ou_path(xi, rho, scale, eta0) -> torch.Tensor:
    """The same recurrence by a log-depth Hillis-Steele scan over time (JAX
    ``pallas_year.py:316-349``): ``y = scale * xi``, ``p = rho``; at
    distance ``d = 1, 2, 4, ...``: ``y_t = fma(rho^d, y_{t-d}, y_t)`` and
    ``p_t = p_t * p_{t-d}`` (zero / one below row ``d``), ``rho^d`` by
    squaring; then ``eta_t = fma(p_t, eta0, y_t)``. It regroups the serial
    rounding (engine parity with :func:`ou_path`, not bitwise); scale 0 with
    eta0 0 is exactly 0."""
    fma = _fma(xi.dtype)
    nt, K = xi.shape
    rho, scale, eta0 = (_member_col(v, K, xi.dtype, xi.device) for v in (rho, scale, eta0))
    y = scale * xi
    p = rho.expand(nt, K)
    r_d, d = rho, 1
    while d < nt:
        y = fma(r_d.expand(nt, K), torch.cat([torch.zeros_like(y[:d]), y[:-d]]), y)
        p = p * torch.cat([torch.ones_like(p[:d]), p[:-d]])
        r_d = r_d * r_d
        d *= 2
    return fma(p, eta0.expand(nt, K), y)


def keys_tensor(noise_keys, K: int, device) -> torch.Tensor:
    """``(K, 2)`` uint32 key data (numpy, or an integer tensor) as a
    contiguous int32 tensor with the same bits, on ``device``."""
    if torch.is_tensor(noise_keys):
        if (noise_keys.dtype == torch.int32 and tuple(noise_keys.shape) == (K, 2)
                and noise_keys.device == torch.device(device)):
            return noise_keys.contiguous()  # already the kernel's form
        keys = noise_keys.to(torch.int64).cpu().numpy()
    else:
        keys = np.asarray(noise_keys)
    if keys.shape != (K, 2) or not np.issubdtype(keys.dtype, np.integer):
        raise ValueError(
            f"noise_keys must be a ({K}, 2) uint32 key-data array, got "
            f"{keys.dtype} {keys.shape}")
    return torch.as_tensor(_key_bits(keys), device=device).contiguous()


def _key_bits(keys: np.ndarray) -> np.ndarray:
    """Integer key data as int32 words with the same low 32 bits."""
    return np.asarray(keys.astype(np.int64) & 0xFFFFFFFF, np.uint32).view(np.int32)


def year_keys(member_keys, years, device) -> torch.Tensor:
    """``(len(years), K, 2)`` int32 on ``device``: row ``y`` is
    ``keys_tensor(prng.fold_in(member_keys, years[y]))``, the keys of the
    absolute year ``years[y]`` for the ``(K, 2)`` uint32 ``member_keys``,
    folded over the years axis in one call and copied to the device once."""
    years = np.asarray(years, np.int64).reshape(-1, 1)
    return torch.as_tensor(_key_bits(prng.fold_in(member_keys, years)), device=device).contiguous()


def noise_offsets(noise, noise_ou, noise_keys, ou_assoc, K: int, nt: int, dtype, device,
                  unroll: int = 1):
    """The plain versions' per-step per-member forcing offsets ``(nt, K)``
    and the year-end OU value ``(K,)`` (None without ``noise_ou``): the
    table itself, or the OU path over the white table (given, or drawn from
    the keys by :func:`.prng.normal_table`), serial (``unroll`` as in
    :func:`ou_path`) or associative."""
    if noise_keys is not None:
        keys = keys_tensor(noise_keys, K, device)
        xi = prng.normal_table(keys, nt).to(dtype)
    else:
        xi = torch.as_tensor(noise, dtype=dtype, device=device)
        if tuple(xi.shape) != (nt, K):
            raise ValueError(f"noise must have shape (nt, K) = ({nt}, {K}), got "
                             f"{tuple(xi.shape)}")
    if noise_ou is None:
        return xi, None
    path = assoc_ou_path(xi, *noise_ou) if ou_assoc else ou_path(xi, *noise_ou, unroll=unroll)
    return path, path[-1]


def block_layout(n: int):
    """``(rows per thread, threads)`` of the block that holds an ``n``-row
    member in the register builds: rows strided over at most 1024 threads,
    whole warps, the least power of two of rows per thread that is enough
    (1, 2 or 4 up to n = 4096; ``csrc/common.cuh::rows_per_thread``). Above
    that (8 to 32) it is the order in which the cluster builds, whatever
    their clusters and threads, sum a crossing area (:func:`block_sum`)."""
    cpt = 1
    while cpt * 1024 < n:
        cpt *= 2
    return cpt, -(-(-(-n // cpt)) // 32) * 32


# The kernels' builds by width: up to "narrow" cells the register builds (a
# warp or a block per member, every per-cell value in registers and shared
# memory), above it up to "max" the wide builds. The year kernels' are
# CLUSTER builds (csrc/cluster.cuh): one thread-block cluster of C blocks per
# member, each block owning ceil(n / C) cells, the PCR rows and the
# neighbour exchange in the owners' shared memory, each cell's record of
# "fields" values there too or, where the C side's plan says they do not
# fit, in a workspace of device memory; the C side picks C (ClusterPlan).
# The Classic build's slice is rounded up to whole chunks of its Tg solve
# ("chunk" cells, ops/tridiag.py::chunked_solve).
# K11's records are its PCR rows alone; K10's are the iterate and the solve's
# frozen inputs. Each cluster loops over members. A wide build sums a
# crossing area in the order of block_layout, whatever its own threads.
WIDE = {
    "classic_year": dict(narrow=4096, max=32768, fields=11, chunk=CHUNK),
    "miz_year": dict(narrow=1024, max=16384, fields=20),
    "pcr_fused": dict(narrow=4096, max=32768, fields=0),
    "newton_t0": dict(narrow=4096, max=16384, fields=5),
}
# the cluster size a cluster build is launched with: 0 lets the C side
# choose (csrc/cluster.cuh::choose_cluster); 2, 4, 8 or 16 forces it
# (tools/kernel_times.py clusters measures each)
FORCE_CLUSTER = {"classic_year": 0, "miz_year": 0, "pcr_fused": 0, "newton_t0": 0}


class ClusterPlan(NamedTuple):
    """What the C side chose for a cluster build (``csrc/*_year.cu::*_cluster_plan``):
    blocks per cluster ``C``, ``threads`` per block, whether each cell's
    record lives in shared memory (else in the workspace), the clusters the
    card keeps resident, and the dynamic shared bytes per block."""
    C: int
    threads: int
    records_shared: bool
    clusters: int
    shared_bytes: int


def wide_words(kernel: str, n: int, C: int) -> int:
    """Words of the run's dtype in one block's part of a cluster build's
    workspace (``csrc/*.cu::*_cluster_words``): the records of the block's
    ``ceil(n / C)`` cells (Classic: rounded up to whole chunks), rounded up
    to 32 words so every block's part starts aligned."""
    chunk = WIDE[kernel].get("chunk", 1)
    words = WIDE[kernel]["fields"] * (-(-(-(-n // C)) // chunk) * chunk)
    return -(-words // 32) * 32


def wide_workspace(kernel: str, n: int, K: int, plan: ClusterPlan | None = None):
    """``(blocks, words per block)`` of the workspace that ``kernel`` takes
    for ``K`` members (systems) of ``n`` cells (rows): ``(0, 0)`` up to the
    register builds' width, which take none. Above it, a cluster build takes
    one only where its ``plan`` keeps the records in device memory: a part
    for each block of the clusters launched (at most the resident ones, each
    looping over members), clusters x C blocks, so it scales with the card,
    not with ``K``. The C side checks the words against its own count.
    Raises past the wide build's width."""
    check_width(kernel, n)
    if n <= WIDE[kernel]["narrow"]:
        return 0, 0
    if plan is None:
        raise ValueError(f"the {kernel} cluster build is sized from the C side's plan")
    if plan.records_shared:
        return 0, 0
    return min(K, plan.clusters) * plan.C, wide_words(kernel, n, plan.C)


@functools.lru_cache(maxsize=None)
def _plan(kernel, n, nt, K, itemsize, index, noisy, ou_mode, count, force_c):
    from . import _build

    lib = _build.load_library()
    suffix = {4: "f32", 8: "f64"}[itemsize]
    out = (ctypes.c_int * 5)()
    if kernel in ("pcr_fused", "newton_t0"):
        name, args = {"pcr_fused": "ebm_pcr_plan", "newton_t0": "ebm_newton_t0_plan"}[kernel], ()
    else:
        name, args = f"ebm_{kernel}_plan", (nt,)
    flags = ((int(noisy), ou_mode) + ((int(count),) if kernel == "miz_year" else ())
             if kernel in ("miz_year", "classic_year") else ())
    with torch.cuda.device(index):
        err = getattr(lib, f"{name}_{suffix}")(n, *args, K, *flags, force_c,
                                               ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        msg = lib.ebm_cuda_error_string(err).decode()
        raise RuntimeError(
            f"the {kernel} cluster build cannot launch at n={n}"
            f"{f' with C={force_c}' if force_c else ''} (float{8 * itemsize}"
            f"{', noisy' if noisy else ''}): CUDA error {err} ({msg})")
    return ClusterPlan(out[0], out[1], bool(out[2]), out[3], out[4])


def cluster_plan(kernel: str, n: int, nt: int, K: int, dtype, device, noisy: bool = False,
                 ou_mode: int = 0, count: bool = False) -> ClusterPlan:
    """The C side's plan of ``kernel``'s cluster build for ``K`` members of
    an ``n``-cell year of ``nt`` steps on ``device`` (the year kernels' build
    by its noise and count flags; K10's and K11's take neither ``nt`` nor
    flags; C as :data:`FORCE_CLUSTER` says, else the widest cluster whose
    resident clusters run all ``K`` members at once); raises ``RuntimeError``
    when the build cannot launch (too much shared memory, or no cluster
    resident)."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _plan(kernel, n, nt if noisy else 1, K, torch.empty((), dtype=dtype).element_size(),
                 index, noisy, ou_mode, count, FORCE_CLUSTER.get(kernel, 0))


def workspace(kernel: str, n: int, K: int, dtype, device, plan: ClusterPlan | None = None):
    """``(tensor or None, pointer or None, words per block, blocks)``: the
    workspace of :func:`wide_workspace`, uninitialised (each kernel writes
    every word before it reads it). The caller holds the tensor until its
    launch is queued; the allocator hands the memory on in stream order."""
    blocks, words = wide_workspace(kernel, n, K, plan)
    if words == 0:
        return None, None, 0, 0
    ws = torch.empty(blocks * words, dtype=dtype, device=device)
    return ws, ws.data_ptr(), words, blocks


def check_raw_fits(nt: int, n_vars: int, K: int, nx: int, dtype, device) -> None:
    """Raise ``ValueError``, naming the memory, when the every-step store of
    a raw-collected year would not fit in what the device has free."""
    need = nt * n_vars * K * nx * torch.empty((), dtype=dtype).element_size()
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    if need > free:
        raise ValueError(
            f"a raw-collected year stores nt*{n_vars}*K*nx = {nt}*{n_vars}*{K}*{nx} values: "
            f"{need / 1e9:.1f} GB, above the {free / 1e9:.1f} GB free on {device}; collect "
            "fewer years raw (raw_mode='none' or 'last') or split the year")


def pcr_shared_bytes(n: int, steps: int, itemsize: int) -> int:
    """The shared memory of a block's PCR solves of ``n`` rows
    (``csrc/common.cuh::pcr_shared_bytes``): two padded buffers of four-value
    rows up to ``n = 1024``, one buffer with one identity row on each side
    above."""
    if n > 1024:
        return 4 * itemsize * (n + 2)
    pad = 1 << (steps - 1) if steps > 0 else 0
    return 4 * itemsize * (2 * n + 3 * pad)


def block_sum(v) -> torch.Tensor:
    """``sum_i v[..., i]`` in the fixed order a thread block of the year
    kernels sums its member's cells (``csrc/noise.cuh::noise_crossing``), so
    kernel and plain version agree bit for bit. With the block of
    :func:`block_layout`, cells beyond the grid counting as 0: a thread adds
    its cells ``t, t + threads, ...`` in that order; within a warp of 32
    threads a halving tree (lane ``l`` adds lane ``l + 16``, then ``+ 8, 4,
    2, 1``); then the warps' sums in warp order."""
    n = v.shape[-1]
    cpt, threads = block_layout(n)
    padded = torch.zeros(v.shape[:-1] + (cpt * threads,), dtype=v.dtype, device=v.device)
    padded[..., :n] = v
    cells = padded.reshape(v.shape[:-1] + (cpt, threads))
    part = cells[..., 0, :]
    for c in range(1, cpt):
        part = part + cells[..., c, :]
    lanes = part.reshape(v.shape[:-1] + (threads // 32, 32))
    for half in (16, 8, 4, 2, 1):
        lanes = lanes[..., :half] + lanes[..., half:2 * half]
    warps = lanes[..., 0]
    total = warps[..., 0]
    for w in range(1, warps.shape[-1]):
        total = total + warps[..., w]
    return total


class CrossingTracker:
    """The first step at which a member's instantaneous ice area crosses its
    threshold: ``sign * (area - thr) > 0``, recorded as the step index (a
    float of the run's dtype; -1 where never crossed), JAX
    ``pallas_year.py:610-619``. The area is ``sum_i w_i field_i`` in the
    order of :func:`block_sum`, as the kernels sum it; ``field`` is MIZ's
    ``phi`` (NaN counted as 0) or Classic's ``E < 0``."""

    def __init__(self, model: str, crossing, st, K: int, dtype, device):
        self.field = "phi" if model == "MIZ" else "E"
        self.w = trapezoid_weights(st.x, dtype, device)
        self.thr, self.sign = (_member_col(v, K, dtype, device) for v in crossing)
        self.first = torch.full((K,), -1.0, dtype=dtype, device=device)

    def __call__(self, t: int, out) -> None:
        v = out[self.field]
        if self.field == "phi":
            v = torch.where(v == v, v, torch.zeros((), dtype=v.dtype, device=v.device))
        else:
            v = (v < 0.0).to(v.dtype)
        area = block_sum(self.w * v)
        crossed = (self.first < 0) & (self.sign * (area - self.thr) > 0)
        self.first = torch.where(crossed, torch.full_like(self.first, float(t)), self.first)


# the shared memory a block can use on Hopper (csrc/noise.cuh)
MAX_SHARED_BYTES = 232448


class NoiseLaunch:
    """The noise arguments of a year kernel's C entry point: seven pointers
    (table, keys, OU rows, year-end eta, crossing rows, first-crossing
    steps, trapezoid weights; null where unused), the OU mode, and the
    output tensors. Built after :func:`check_noise_args`; ``weights`` are
    the grid's trapezoid weights on the device (:class:`YearTables`)."""

    def __init__(self, noise, noise_ou, noise_keys, ou_assoc, crossing, st, K: int,
                 dtype, device, base_shared_bytes: int, weights, unroll: int = 1):
        nt = st.nt
        self.unroll = unroll
        self.noisy = noise is not None or noise_keys is not None
        self.ou_mode = 0 if noise_ou is None else (2 if ou_assoc else 1)
        if self.noisy:
            rows = 4 if self.ou_mode == 2 else 1
            need = base_shared_bytes + rows * nt * torch.empty((), dtype=dtype).element_size()
            if need > MAX_SHARED_BYTES:
                raise ValueError(
                    f"a noisy year keeps its member's nt={nt} noise row"
                    f"{' and the scan rows' if rows > 1 else ''} in shared memory: "
                    f"{need} bytes, above the {MAX_SHARED_BYTES} a block has")
        table = None
        if noise is not None:
            table = torch.as_tensor(noise, dtype=dtype, device=device).contiguous()
            if tuple(table.shape) != (nt, K):
                raise ValueError(f"noise must have shape (nt, K) = ({nt}, {K}), got "
                                 f"{tuple(table.shape)}")
        keys = keys_tensor(noise_keys, K, device) if noise_keys is not None else None
        ou = member_rows(noise_ou, K, dtype, device) if noise_ou is not None else None
        self.eta = torch.empty((K,), dtype=dtype, device=device) if noise_ou is not None else None
        cross = member_rows(crossing, K, dtype, device) if crossing is not None else None
        self.first = (torch.empty((K,), dtype=dtype, device=device)
                      if crossing is not None else None)
        if crossing is not None and weights is None:
            raise ValueError("a crossing area needs a grid of at least two cells")
        wts = weights if crossing is not None else None
        self._keep = (table, keys, ou, cross, wts)
        self.ptrs = [None if v is None else v.data_ptr()
                     for v in (table, keys, ou, self.eta, cross, self.first, wts)]


def year_result(out, noise_ou, eta, first):
    """A year's results as the JAX wrappers return them: ``(carry,
    seasonal, converged, raw)`` for a deterministic or a plain noisy year;
    with ``noise_ou`` the fourth is the year-end ``eta``; with a crossing a
    fifth, the first crossing step per member."""
    carry, seasonal, conv, raw = out
    if noise_ou is not None:
        raw = eta
    if first is not None:
        return carry, seasonal, conv, raw, first
    return carry, seasonal, conv, raw
