"""Carry parameters, initial conditions and state across the package
boundary.

The JAX package and this port keep the same layouts at every public function
(``(K, nx)`` state, ``(nt, nx)`` raw years), so moving data between them is a
change of array type only: pass the JAX side's arrays as numpy
(``np.asarray(jax_array)``) to :func:`from_numpy`, and hand :func:`to_numpy`'s
result back to it.
"""
from __future__ import annotations

import numpy as np
import torch

from .solutions import Seasonal
from .utils.collection import Collection

__all__ = ["from_numpy", "to_numpy"]


def from_numpy(collection, dtype=torch.float64, device="cpu"):
    """Tensors of ``dtype`` on ``device`` from a (nested) mapping of numpy
    arrays or scalars — parameters, initial conditions, a carry (MIZ or
    Classic), or a :class:`Seasonal` of Collections — or from a tuple of
    them, such as the argument tuple of JAX ``pallas_solve_T0`` for
    :func:`.ops.newton_t0.newton_t0`."""
    if isinstance(collection, Seasonal):
        return Seasonal(*(from_numpy(c, dtype, device) for c in collection))
    if isinstance(collection, dict):
        return Collection({k: from_numpy(v, dtype, device) for k, v in collection.items()})
    if isinstance(collection, tuple):
        return tuple(from_numpy(v, dtype, device) for v in collection)
    return torch.as_tensor(np.asarray(collection), dtype=dtype, device=device)


def to_numpy(collection):
    """The inverse of :func:`from_numpy`: numpy arrays (on the host) from a
    (nested) mapping of tensors, a :class:`Seasonal`, a tuple, or one
    tensor."""
    if isinstance(collection, Seasonal):
        return Seasonal(*(to_numpy(c) for c in collection))
    if isinstance(collection, dict):
        return Collection({k: to_numpy(v) for k, v in collection.items()})
    if isinstance(collection, tuple):
        return tuple(to_numpy(v) for v in collection)
    if torch.is_tensor(collection):
        return collection.detach().cpu().numpy()
    return np.asarray(collection)
