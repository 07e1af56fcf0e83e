"""Persistent-state function wrapper (a copy of the JAX package's
``utils/persistent.py``).

Rebuild of the reference's ``@persistent`` macro
(EnergyBalanceModel.jl src/utilities.jl:126-170), which wraps a function in a
``let`` block of captured mutable variables — memoization across calls (the
diffusion-operator cache, classic statics, and the MIZ warm start all use
it).

In this package those three uses map onto other mechanisms:

- operator/statics caches -> the statics each year function builds once
  (:func:`..integrate.make_year_fn`);
- the MIZ warm start -> the ``T0`` field of the carry that the year loop
  threads from step to step (:func:`..models.miz.init_carry`).

This decorator provides the general host-side primitive for user code: the
wrapped function receives a mutable ``state`` dict (seeded from the keyword
defaults) as its first argument, persisting across calls.

Examples
--------
>>> @persistent(cache=None)
... def get_op(state, nx):
...     if state["cache"] is None or state["cache"].shape != (nx,):
...         state["cache"] = expensive_build(nx)
...     return state["cache"]
"""
from __future__ import annotations

import functools

__all__ = ["persistent"]


def persistent(**initial):
    def decorate(fn):
        state = dict(initial)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return fn(state, *args, **kwargs)

        wrapper.state = state
        return wrapper

    return decorate
