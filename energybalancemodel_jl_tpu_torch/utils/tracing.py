"""Profiler spans of the port's own phases.

Wrap a call in ``torch.profiler.profile`` (or pass ``integrate(profile_dir=)``)
and the trace holds, beside PyTorch's operators and the device's kernels and
copies, the spans the entry points and the year wrappers open, on the same
clock:

- ``ebm.ensemble_integrate``, ``ebm.integrate``, ``ebm.transitions``: the
  whole call;
- ``ebm.<entry>.prepare``: parameters, initial carry and forcing table (in
  ``transitions`` also every year's keys) to the device, up to the year loop;
- ``ebm.<entry>.year``: one model year, the wrapper call included (in
  ``transitions`` also the yearly area and means);
- ``ebm.<entry>.checkpoint``: one checkpoint write;
- ``ebm.<entry>.assemble``: the stores stacked and copied to numpy, and the
  result built;
- ``ebm.transitions.reference``: the attractors' reference years;
- ``ebm.year.miz``, ``ebm.year.classic``: a whole-year wrapper from entry to
  return (argument checks, parameter stack, the cached tables, allocations,
  the launch; on the CPU its plain version).

Spans nest by the call stack. A span opens only while a profiler records on
the calling thread, so with none it costs one flag read; PyTorch's profiler
records the thread that started it, not a mesh shard's threads.
"""
from __future__ import annotations

import contextlib
import functools
import os

import torch

__all__ = ["span", "traced", "profiled"]

# the context every span() returns while no profiler records: reusable and
# re-entrant, so one instance serves every call
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` in the profiler's trace while one
    records on this thread, else a shared no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def traced(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


@contextlib.contextmanager
def profiled(profile_dir, device, filename: str):
    """Record the body with ``torch.profiler`` (host activity, and
    the card's where ``device`` is a CUDA device) and write it to
    ``profile_dir/filename`` as a Chrome trace; with ``profile_dir=None``
    do nothing. ``device=None`` stands for the CUDA device where there is
    one. The recording ends even where the body raises; a trace is written
    only where it returns."""
    if profile_dir is None:
        yield
        return
    on_card = (torch.device(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        try:
            if on_card:
                torch.cuda.synchronize(device)
        finally:
            prof.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, filename))
