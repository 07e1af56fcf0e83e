"""What a model year costs by the model's own equations, whatever computes
it: the floating-point operations of the plain reference's arithmetic, and
the bytes of a year's inputs and outputs, each counted once.

Operations are counted by running the reference itself under a dispatch
mode, on the CPU in float64 (where each fused multiply-add is one
``addcmul``), one member at the cell's grid: each add, subtract, multiply,
divide, negation, power, minimum, maximum and absolute value is one
operation per element, a fused multiply-add and a clamp two, a reduction
one per element reduced; comparisons and selects (the guards of divisions
and of non-finite values), casts, logical operations and data movement
none. What the reference does only to round as the program does is not the
model's work and is left out: the emulated flush of subnormals counts
nothing, and a tridiagonal solve, which the reference makes by cyclic
reduction (n log n), counts the ``8 n - 7`` operations of a direct
(Thomas) solve of its ``n`` rows. A MIZ step is counted without its Newton
updates, and an update apart, since the updates a member needs depend on
its state."""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .reference import MODELS, common, prng, run_years
from .reference.common import Grid

_ONE = {"add", "sub", "rsub", "mul", "div", "neg", "pow", "reciprocal", "sqrt", "minimum",
        "maximum", "abs"}
_TWO = {"addcmul", "clamp"}
_REDUCE = {"amax", "amin", "sum", "any"}
_INT = {"add", "sub", "bitwise_xor", "bitwise_and", "bitwise_or", "bitwise_left_shift",
        "bitwise_right_shift", "lshift", "rshift", "xor", "and", "or"}


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0
        self.ints = 0
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.paused:
            return out
        name = func.overloadpacket.__name__.rstrip("_")
        integer = torch.is_tensor(out) and not out.is_floating_point() and out.dtype != torch.bool
        if integer:
            if name.strip("_") in _INT:
                self.ints += out.numel()
        elif name in _ONE or name in _TWO:
            n = out.numel() if torch.is_tensor(out) else 1
            self.flops += n * (2 if name in _TWO else 1)
        elif name in _REDUCE:
            self.flops += args[0].numel()
        return out


def _uncounted(counter, fn, cost=None):
    """``fn`` with the counter paused; ``cost(*args)`` operations counted
    instead where given."""
    def run(*args, **kwargs):
        counter.paused += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            counter.paused -= 1
        if cost is not None:
            counter.flops += cost(*args)
        return out
    return run


def _thomas(lo, di, up, b):
    """The operations of a direct solve of ``b``'s systems: ``8 n - 7``
    a system of ``n`` rows (the forward sweep 5, the back substitution 3 a
    row)."""
    n = b.shape[-1]
    return (8 * n - 7) * (b.numel() // n)


@contextlib.contextmanager
def _model_work(counter):
    """The reference's modules with the flush and the solve counted as the
    model's work (above) for the block."""
    mods = [MODELS[m] for m in sorted(MODELS)]
    saved = [(mod, name, getattr(mod, name)) for mod in mods
             for name in ("flush", "pcr_solve") if hasattr(mod, name)]
    try:
        for mod, name, fn in saved:
            setattr(mod, name, _uncounted(counter, fn, _thomas if name == "pcr_solve" else None))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _count(model, nx, nt, par, init, newton):
    with _Counter() as c, _model_work(c):
        run_years(model, Grid(nx, nt), par, init, 1, torch.float64, "cpu", newton)
    return c.flops


@functools.lru_cache(maxsize=None)
def year_flops(model: str, nx: int, nt: int, params: tuple, newton: tuple = ()):
    """``(per_member_year, per_update)``: the operations of one member's
    model year without Newton updates, and of one Newton update (0 for
    Classic). ``params`` and ``newton`` are the configuration's, as item
    tuples. The counts do not depend on the state, which is zero here."""
    par = dict(params)
    start = {k: np.zeros((1, nx)) for k in MODELS[model].CARRY if k != "T0"}
    cfg = dict(newton) if newton else None
    none = dict(cfg, max_iter=0) if cfg else None
    two = _count(model, nx, 2, par, start, none)
    three = _count(model, nx, 3, par, start, none)
    per_step = three - two
    per_year = two - 2 * per_step + nt * per_step
    per_update = 0
    if cfg:
        once = dict(cfg, max_iter=1, abstol=0.0, reltol=0.0)
        per_update = (_count(model, nx, 2, par, start, once) - two) // 2
    return per_year, per_update


@functools.lru_cache(maxsize=None)
def weather_ops(nt: int):
    """``(operations, integer operations)`` of one member-year's weather in
    the keys mode: ``nt`` float32 draws (the threefry cipher's 32-bit word
    operations counted as integer operations, the float pipeline as
    operations), the recurrence over them and the forcing offsets added.
    Each fused multiply-add counts two, as it would rounding once."""
    once = common.addcmul_rounds_once
    common.addcmul_rounds_once = lambda device_type: True
    try:
        with _Counter() as c:
            xi = prng.normal_table(np.zeros((1, 2), np.uint32), nt, "cpu")
            one = torch.ones(1)
            path = prng.ou_path(xi, one, one, torch.zeros(1))
            torch.zeros(nt, 1) + path
    finally:
        common.addcmul_rounds_once = once
    return c.flops, c.ints


def year_bytes(model: str, nx: int, nt: int, members: int, itemsize: int,
               weather: bool = False) -> int:
    """The bytes a year of ``members`` reads and writes once each: the state
    in and out, the parameters (and a forcing offset) per member, the grid
    tables (x, x^2 and three stencil bands) and the cos and forcing rows in,
    the three seasonal stores of every recorded variable and one Newton flag
    per member out."""
    mod = MODELS[model]
    carry, out, npar = len(mod.CARRY), len(mod.OUT_VARS), len(mod.PARAMS) + 1
    words = (members * nx * (2 * carry + 3 * out) + members * (npar + 1) + 5 * nx + 2 * nt)
    if weather:  # per member: its key (two words), rho and scale, the weather in and out
        return itemsize * (words + 4 * members) + 8 * members
    return itemsize * words
