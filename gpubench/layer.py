"""The arithmetic of the per-layer metrics, shared by the readers under
``metrics/``: each reader binds one of these to its metric's name. A
function returns None where the run has nothing for it to read: no kernel of
the configured names in the trace, or no peak for this device."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .trace import Trace


@dataclass
class Context:
    trace: Trace
    kernel_pattern: str  # the configuration's year-kernel names (a regex)
    member_year_flops: float  # the equations' operations of one member-year
    launch_members: int  # members one year-kernel launch integrates
    itemsize_bytes_per_launch: int  # a launch's inputs and outputs, once each
    window_s: float  # the measured window, host clock
    member_years: float  # member-years completed in the window
    flops_peak: Optional[float]  # this device's peak for the dtype, per second
    bytes_peak: Optional[float]  # this device's memory bandwidth, bytes per second
    member_year_int_ops: float = 0.0  # integer operations of one member-year (the draws)
    int_peak: Optional[float] = None  # this device's 32-bit integer operations per second


def kernel_ms(ctx: Context):
    """Mean device time of one launch of the configured year kernel, ms."""
    ks = ctx.trace.kernels(ctx.kernel_pattern)
    return sum(ks) / len(ks) * 1e3 if ks else None


def roofline(ctx: Context):
    """The least time the card could take for one launch's work (the largest
    of its operations over the peak rate, its integer operations over the
    integer rate, and its bytes over the bandwidth),
    as a share of the launch's measured device time, %."""
    ks = ctx.trace.kernels(ctx.kernel_pattern)
    if not ks or not ctx.flops_peak or not ctx.bytes_peak:
        return None
    bound = max(ctx.member_year_flops * ctx.launch_members / ctx.flops_peak,
                ctx.itemsize_bytes_per_launch / ctx.bytes_peak)
    if ctx.member_year_int_ops and ctx.int_peak:
        bound = max(bound, ctx.member_year_int_ops * ctx.launch_members / ctx.int_peak)
    return 100.0 * bound / (sum(ks) / len(ks))


def mfu(ctx: Context):
    """The operations of every member-year completed in the window, over the
    window times the peak rate, %."""
    if not ctx.flops_peak or ctx.member_years <= 0:
        return None
    return 100.0 * ctx.member_years * ctx.member_year_flops / (ctx.window_s * ctx.flops_peak)


def idle_share(ctx: Context):
    """The share of the traced window in which the device ran no kernel and
    no copy, %."""
    w = ctx.trace.window_s
    return 100.0 * (1.0 - ctx.trace.busy_s() / w) if w > 0 else None
