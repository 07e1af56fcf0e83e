"""Reduction of a ``torch.profiler`` trace of the measured window: the
device's busy intervals, the time of the kernels a configuration names, the
operations that took the most device time, and the longest idle gaps named
by what the host was doing in them."""
from __future__ import annotations

import re
from dataclasses import dataclass, field

from torch.autograd import DeviceType

WINDOW = "gpubench.window"
CALL = "gpubench.call"
KEEP = "gpubench.keep"
_DEVICE = {"kernel", "gpu_memcpy", "gpu_memset"}


@dataclass
class Trace:
    window: tuple  # (start_ns, end_ns) of the window's annotation
    device: list = field(default_factory=list)  # (start_ns, end_ns, name, kind)
    host: list = field(default_factory=list)  # (start_ns, end_ns, name)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy(self):
        """The union of the device's intervals inside the window, merged."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for s, e, _, _ in self.device
                       if e > lo and s < hi)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-9

    def kernels(self, pattern: str):
        """Durations (s) of the kernels in the window whose names match."""
        rx = re.compile(pattern)
        lo, hi = self.window
        return [(e - s) * 1e-9 for s, e, name, kind in self.device
                if kind == "kernel" and s >= lo and e <= hi and rx.search(name)]

    def device_ops(self, top: int = 10):
        """``[name, seconds]`` of the device operations that took the most
        time in the window, summed by name."""
        lo, hi = self.window
        total = {}
        for s, e, name, _ in self.device:
            if e > lo and s < hi:
                total[name] = total.get(name, 0.0) + (min(e, hi) - max(s, lo)) * 1e-9
        return [[_short(n), t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """``[host activity, seconds]`` of the longest gaps in the window in
        which the device ran nothing, each named by the innermost host span
        that covers the gap's middle."""
        lo, hi = self.window
        edges = [lo] + [t for span in self.busy() for t in span] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:top]:
            mid = (s + e) // 2
            covering = [(he - hs, name) for hs, he, name in self.host if hs <= mid <= he]
            out.append([_short(min(covering)[1]) if covering else "no host span",
                        (e - s) * 1e-9])
        return out


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


def _kind(ev) -> str:
    """The activity kind of a profiler event: from ``activity_type()``
    where PyTorch has it, else from the device it ran on and its name."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    on_card = ev.device_type() == DeviceType.CUDA
    annotation = getattr(ev, "is_user_annotation", None)
    if (annotation() if annotation else ev.name().startswith("gpubench.")):
        return "gpu_user_annotation" if on_card else "user_annotation"
    if not on_card:
        return "host"
    name = ev.name()
    return ("gpu_memcpy" if name.startswith("Memcpy") else
            "gpu_memset" if name.startswith("Memset") else "kernel")


def from_profiler(prof) -> Trace:
    """Read a finished ``torch.profiler.profile`` whose window was wrapped
    in ``record_function(WINDOW)``."""
    window = None
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if kind in _DEVICE:
            device.append((start, end, ev.name(), kind))
        else:
            host.append((start, end, ev.name()))
            if ev.name() == WINDOW:
                window = (start, end)
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW!r} span")
    return Trace(window=window, device=device, host=host)
