"""The ice-area diagnostic of the JAX package's ``fold.py``.

Only :func:`seasonal_ice_area` is ported, for the noise-forced
``transitions``; fold tracking itself waits for ``equilibrate`` (ROADMAP
Queue 1 M11).
"""
from __future__ import annotations

import numpy as np

from .spacetime import SpaceTime
from .utils.numerics import hemispheric_mean

__all__ = ["seasonal_ice_area"]


def seasonal_ice_area(coll, st: SpaceTime) -> np.ndarray:
    """Ice-covered area ``2 pi <field>`` of one seasonal store — ``phi``
    where the model has it (MIZ), else the ``E < 0`` indicator (Classic) —
    in float64 on the host, batched over leading (member) axes (JAX
    ``fold.py:40-49``)."""
    if "phi" in coll:
        field = np.nan_to_num(np.asarray(coll["phi"], dtype=np.float64))
    else:
        field = (np.asarray(coll["E"]) < 0.0).astype(np.float64)
    return 2.0 * np.pi * np.asarray(hemispheric_mean(field, st.x))
