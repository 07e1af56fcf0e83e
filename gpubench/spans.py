"""Per-layer metrics read from the program's own profiler spans: the
``ebm.*`` annotations that the port's entry points and year wrappers open
(``energybalancemodel_jl_tpu_torch/utils/tracing.py``), put against the
device's busy time of the same trace. Each reader returns None where the
trace holds none of the spans it reads, as in a program without them."""
from __future__ import annotations

import itertools
import re
from bisect import bisect_left, bisect_right

from .layer import Context
from .trace import Trace

ROOTS = ("ebm.ensemble_integrate", "ebm.integrate", "ebm.transitions")
ASSEMBLE = tuple(f"{root}.assemble" for root in ROOTS)
YEAR = "ebm.year."
REFERENCE = "ebm.transitions.reference"
NS_PER_MS = 1e6


def host_spans(trace: Trace, match) -> list:
    """``(start_ns, end_ns, name)`` of the host-side ``ebm.*`` spans in the
    window whose names ``match`` accepts, in order of start.

    With device activity the profiler also records a device-side copy of
    each annotation that launched device work, from the start of the first
    device operation it launched to the end of the last; ``Trace.host``
    holds both copies and not their kind. A device-side copy starts where a
    device operation starts and ends where one ends, to the nanosecond, so
    an entry that does both is left out."""
    starts = {s for s, _, _, _ in trace.device}
    ends = {e for _, e, _, _ in trace.device}
    lo, hi = trace.window
    return sorted((s, e, name) for s, e, name in trace.host
                  if name.startswith("ebm.") and match(name) and lo <= s and e <= hi
                  and not (s in starts and e in ends))


def _merged(spans) -> list:
    """The union of ``(start, end, ...)`` intervals, as sorted ``[start,
    end]`` pairs."""
    out = []
    for s, e, *_ in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _Busy:
    """The device's busy time inside any interval of the window."""

    def __init__(self, trace: Trace):
        busy = trace.busy()
        self.starts = [s for s, _ in busy]
        self.ends = [e for _, e in busy]
        self.before = [0] + list(itertools.accumulate(e - s for s, e in busy))

    def within(self, s: int, e: int) -> int:
        i = bisect_right(self.ends, s)  # the first busy interval ending after s
        j = bisect_left(self.starts, e)  # past the last one starting before e
        if i >= j:
            return 0
        return (self.before[j] - self.before[i] - max(0, s - self.starts[i])
                - max(0, self.ends[j - 1] - e))

    def idle(self, intervals) -> int:
        """Idle ns over the union of ``intervals``."""
        return sum(e - s - self.within(s, e) for s, e in _merged(intervals))


def _years(trace: Trace) -> list:
    return host_spans(trace, lambda name: name.startswith(YEAR))


def _roots(trace: Trace) -> list:
    """The calls: the outermost host-side root spans."""
    return _merged(host_spans(trace, lambda name: name in ROOTS))


def wrapper_idle_ms(ctx: Context):
    """The device's idle time inside the host's ``ebm.year.*`` spans (a
    whole-year wrapper from entry to return), per span: per year launch, ms."""
    years = _years(ctx.trace)
    if not years:
        return None
    return _Busy(ctx.trace).idle(years) / len(years) / NS_PER_MS


def entry_idle_ms(ctx: Context):
    """The device's idle time inside the host's root spans (a call to an
    entry point) but outside every ``ebm.year.*`` span, per call, ms."""
    roots = _roots(ctx.trace)
    if not roots:
        return None
    busy = _Busy(ctx.trace)
    starts = [s for s, _ in roots]
    inside = []
    for s, e, _ in _years(ctx.trace):
        k = bisect_right(starts, s) - 1
        if k >= 0:
            inside.append((max(s, roots[k][0]), min(e, roots[k][1])))
    inside = [(s, e) for s, e in inside if e > s]
    return (busy.idle(roots) - busy.idle(inside)) / len(roots) / NS_PER_MS


def assemble_ms(ctx: Context):
    """Per call, from the end on the device of the call's last year kernel
    (``ctx.kernel_pattern``) to the end of the host's ``ebm.<entry>.assemble``
    span: the copies and host work after the call's last kernel, ms."""
    tr = ctx.trace
    rx = re.compile(ctx.kernel_pattern)
    lo, hi = tr.window
    kernels = sorted((e, s) for s, e, name, kind in tr.device
                     if kind == "kernel" and lo <= s and e <= hi and rx.search(name))
    ends = [e for e, _ in kernels]
    roots = _roots(tr)
    starts = [s for s, _ in roots]
    gaps = []
    for s, e, _ in host_spans(tr, lambda name: name in ASSEMBLE):
        k = bisect_right(starts, s) - 1
        call_start = roots[k][0] if k >= 0 else lo
        j = bisect_right(ends, e) - 1  # the last year kernel to end before the span does
        if j >= 0 and kernels[j][1] >= call_start:
            gaps.append(e - kernels[j][0])
    return sum(gaps) / len(gaps) / NS_PER_MS if gaps else None


def reference_share(ctx: Context):
    """The share of the window inside the host's
    ``ebm.transitions.reference`` spans (the attractors' reference years), %."""
    refs = host_spans(ctx.trace, lambda name: name == REFERENCE)
    lo, hi = ctx.trace.window
    if not refs or hi <= lo:
        return None
    return 100.0 * sum(e - s for s, e in _merged(refs)) / (hi - lo)
