"""Numerics shared by the plain reference years: the grid, the diffusion
bands, the single-rounding multiply-add, the host cosine, the subnormal
flush and the tridiagonal solve by parallel cyclic reduction.

A frozen copy, made for the benchmark, of the arithmetic the MIZ and Classic
years of EnergyBalanceModel.jl need (``src/infrastructure.jl``), in the
order of operations the port's plain versions use, so that a year computed
here in float32 rounds as theirs do. Nothing here imports the program under
test.
"""
from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Grid:
    """``SpaceTime{sin}(nx, nt, dur)`` of the reference
    (``src/infrastructure.jl:109-166``): cell midpoints uniform in latitude,
    ``x`` their sine, ``nt`` steps a year, the seasonal snapshots at the
    1-based steps ``round(nt * 0.26125)`` and ``round(nt * 0.77375)``."""

    nx: int
    nt: int

    @property
    def x(self) -> np.ndarray:
        du = (math.pi / 2.0) / self.nx
        return np.sin((np.arange(self.nx, dtype=np.float64) + 0.5) * du)

    @property
    def dt(self) -> float:
        return 1.0 / self.nt

    @property
    def t(self) -> np.ndarray:
        return np.linspace(self.dt / 2.0, 1.0 - self.dt / 2.0, self.nt)

    @property
    def winter(self) -> int:
        """0-based step of the winter snapshot."""
        return int(np.round(self.nt * 0.26125)) - 1

    @property
    def summer(self) -> int:
        """0-based step of the summer snapshot."""
        return int(np.round(self.nt * 0.77375)) - 1


def bands_uniform(nx: int):
    """``get_diffop`` of the uniform grid (``src/infrastructure.jl:480-491``)
    as tridiagonal bands ``(lo, di, up)``, float64."""
    dx = 1.0 / nx
    xb = np.arange(1, nx, dtype=np.float64) * dx
    lam = (1.0 - xb**2) / dx**2
    lo = np.concatenate(([0.0], lam))
    up = np.concatenate((lam, [0.0]))
    return lo, -(lo + up), up


def bands_general(x: np.ndarray):
    """The flux-form stencil of a general grid (``diffusion!``,
    ``src/infrastructure.jl:505-527``): reflective ghosts, edge midpoints,
    zero-flux ends; float64 bands ``(lo, di, up)``."""
    xg = np.concatenate(([-x[0]], x, [2.0 - x[-1]]))
    diffx = np.diff(xg)
    xxph = (xg[2:] + xg[1:-1]) / 2.0
    xxmh = (xg[1:-1] + xg[:-2]) / 2.0
    phmmh = xxph - xxmh
    a = (1.0 - xxph**2) / diffx[1:] / phmmh
    b = (1.0 - xxmh**2) / diffx[:-1] / phmmh
    a[-1] = 0.0
    b[0] = 0.0
    return b.copy(), -(a + b), a.copy()


def host_cos(x: torch.Tensor) -> torch.Tensor:
    """``cos`` by the C library in double, rounded to ``x``'s dtype."""
    vals = [math.cos(v) for v in x.detach().cpu().double().reshape(-1).tolist()]
    return torch.tensor(vals, dtype=torch.float64).reshape(x.shape).to(x.dtype)


def _fma_f32_emulated(a, b, c):
    """``a * b + c`` in float32 with one rounding, from float64 arithmetic
    made round-to-odd (finite operands)."""
    dt = torch.float64
    a, b, c = (torch.as_tensor(v).to(dt) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    odd = torch.nextafter(s, torch.where(err > 0, torch.full_like(s, np.inf),
                                         torch.full_like(s, -np.inf)))
    return torch.where((err != 0) & even, odd, s).to(torch.float32)


@functools.lru_cache(maxsize=None)
def addcmul_rounds_once(device_type: str) -> bool:
    """Whether ``torch.addcmul`` in float32 on this kind of device is a fused
    multiply-add, checked on seeded operands and a case two roundings miss."""
    dev = torch.device(device_type)
    g = torch.Generator().manual_seed(0)
    a, b, c = (torch.randn(4099, generator=g, dtype=torch.float32) for _ in range(3))
    a[0] = b[0] = 1.0 + 2.0 ** -12
    c[0] = -1.0
    got = torch.addcmul(c.to(dev), a.to(dev), b.to(dev)).cpu()
    return bool(torch.equal(got, _fma_f32_emulated(a, b, c)))


FUSED = [True]  # False: every fma below rounds twice, a sound reordering's witness


@contextlib.contextmanager
def separate_roundings():
    """Within the block :func:`fma` rounds its product and its sum apart:
    the same equations in another order of roundings, which a correct
    program that contracts differently might compute."""
    FUSED[0] = False
    try:
        yield
    finally:
        FUSED[0] = True


def fma(a, b, c):
    """``a * b + c`` with one rounding in the dtype of the tensor operands
    (the contraction the models' fused loops make). In a dtype narrower
    than float32, ``torch.addcmul`` (which computes in float32 and rounds
    once to the narrow type)."""
    ref = next(v for v in (a, b, c) if torch.is_tensor(v) and v.is_floating_point())
    dt = ref.dtype
    if not FUSED[0]:
        a, b, c = (v if torch.is_tensor(v) and v.dtype == dt else
                   torch.as_tensor(v, dtype=dt, device=ref.device) for v in (a, b, c))
        return a * b + c
    if dt != torch.float32 or addcmul_rounds_once(ref.device.type):
        a, b, c = (v if torch.is_tensor(v) and v.dtype == dt else
                   torch.as_tensor(v, dtype=dt, device=ref.device) for v in (a, b, c))
        return torch.addcmul(c, a, b)
    return _fma_f32_emulated(a, b, c)


def flush(x):
    """Subnormal values to zeros of their sign (the backends' flush to zero
    that the MIZ step reproduces where a value reaches a division)."""
    return x * ((torch.abs(x) >= torch.finfo(x.dtype).tiny) | (x == 0))


def neighbors(v):
    """``(v_{i-1}, v_{i+1})`` along the last axis; the wrapped ends meet zero
    band entries."""
    return torch.roll(v, 1, dims=-1), torch.roll(v, -1, dims=-1)


def _shift(v, s: int, fill: float = 0.0):
    """``out[i] = v[i - s]`` along the last axis, ``fill`` where out of range."""
    n = v.shape[-1]
    if abs(s) >= n:
        return torch.full_like(v, fill)
    kept = v.narrow(-1, 0, n - s) if s > 0 else v.narrow(-1, -s, n + s)
    return torch.nn.functional.pad(kept, (s, 0) if s > 0 else (0, -s), value=fill)


def pcr_levels(n: int) -> int:
    return max(1, math.ceil(math.log2(n))) if n > 1 else 0


def pcr_solve(lo, di, up, b, negated: bool = False):
    """Solve the tridiagonal system ``lo x[i-1] + di x[i] + up x[i+1] = b``
    along the last axis by parallel cyclic reduction, rows first scaled by
    their diagonal; each level's sums as the models' fused multiply-adds
    (``negated``: ``b`` is a negation, as a Newton update's ``-r``, which
    moves the first level's contraction)."""
    steps = pcr_levels(b.shape[-1])
    inv = 1.0 / di
    lo = lo * inv
    up = up * inv
    di = torch.ones_like(di)

    def safe_div(num, den):
        zero = den == 0
        return torch.where(zero, 0.0, num / torch.where(zero, 1.0, den))

    s = 1
    for level in range(steps):
        alpha = safe_div(-lo, _shift(di, s, 1.0))
        beta = safe_div(-up, _shift(di, -s, 1.0))
        if level == 0:
            b_s = b * inv
            if negated:
                t = fma(alpha, _shift(b_s, s), b_s)
            else:
                t = fma(b, inv, alpha * _shift(b_s, s))
            b = fma(beta, _shift(b_s, -s), t)
        elif level < steps - 1:
            b = fma(beta, _shift(b, -s), fma(alpha, _shift(b, s), b))
        else:
            b = fma(beta, _shift(b, -s), b + alpha * _shift(b, s))
        if level < steps - 1 or steps == 1:
            di = fma(beta, _shift(lo, -s), fma(alpha, _shift(up, s), di))
        else:
            di = fma(beta, _shift(lo, -s), di + alpha * _shift(up, s))
        lo = alpha * _shift(lo, s)
        up = beta * _shift(up, -s)
        s *= 2
    if steps == 0:
        return (b * inv) / di
    return b / di


def columns(values, K: int, dtype, device) -> torch.Tensor:
    """A ``(K, 1)`` column of a scalar or of ``K`` per-member values."""
    v = torch.as_tensor(np.asarray(values, dtype=np.float64), dtype=dtype, device=device)
    return (v.expand(K) if v.ndim == 0 else v.reshape(K))[:, None]


class Replay:
    """``fn()``, a function that reads fixed tensors and writes its results
    into fixed tensors with ``copy_``: run eagerly on the CPU, and on a CUDA
    device captured once as a CUDA graph and replayed (the same kernels on
    the same operands, without the host's launch cost; the reference is
    launch-bound at these sizes). ``state`` lists the tensors ``fn`` writes:
    the warm-up run before the capture changes them, so they are put back."""

    def __init__(self, fn, state):
        self.fn, self.state, self.graph = fn, state, None

    def __call__(self):
        if self.state[0].device.type != "cuda":
            self.fn()
            return
        if self.graph is None:
            saved = [v.clone() for v in self.state]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.fn()
            torch.cuda.current_stream().wait_stream(side)
            for v, old in zip(self.state, saved):
                v.copy_(old)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.fn()
        self.graph.replay()


class Seasonal:
    """The seasonal store of a year, built as the steps run: the winter and
    summer snapshots and the annual sums over ``nt``, summed in step order
    from step 0's outputs."""

    def __init__(self, grid: Grid, out: dict):
        self.grid, self.out = grid, out
        self.acc = {k: torch.zeros_like(v) for k, v in out.items()}

    def add(self, first: bool):
        """The accumulation of the step's outputs (capturable)."""
        for k, v in self.out.items():
            self.acc[k].copy_(v if first else self.acc[k] + v)

    def snapshot(self, t: int, stores: dict):
        if t == self.grid.winter:
            stores["winter"] = {k: v.clone() for k, v in self.out.items()}
        if t == self.grid.summer:
            stores["summer"] = {k: v.clone() for k, v in self.out.items()}

    def average(self, stores: dict):
        ref = next(iter(self.acc.values()))
        nt = torch.as_tensor(float(self.grid.nt), dtype=ref.dtype, device=ref.device)
        stores["avg"] = {k: v / nt for k, v in self.acc.items()}
        return stores
