"""The comparison that decides ``correct``: the program's outputs of the
checked members against the plain reference's, value by value.

A model year in float32 amplifies one rounding where a cell freezes or
melts, so a sound program that orders its arithmetic otherwise (contracts
other products into fused multiply-adds, or computes in float64) lands
within a few thousandths of the reference's value in most places and
farther off at a few cells near the ice edge. The comparison therefore
counts: a value agrees where it lies within ``TOL`` of the reference's,
relative to the largest magnitude the reference gives that variable over
all checked members, stores and years, and where it is NaN exactly where
the reference's is (the stores NaN-mask ice-free and ice-covered cells).
The number compared is the share of values that do not agree."""
from __future__ import annotations

import numpy as np

from .reference import STORES

TOL = 1e-3


def _disagree(got, ref) -> tuple:
    """``(values that disagree, values)`` of one variable."""
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        return max(ref.size, 1), max(ref.size, 1)
    nan_got, nan_ref = np.isnan(got), np.isnan(ref)
    both = np.isfinite(got) & np.isfinite(ref)
    scale = float(np.max(np.abs(ref[np.isfinite(ref)]), initial=0.0))
    gap = np.abs(np.where(both, got, 0.0) - np.where(both, ref, 0.0))
    bad = (nan_got != nan_ref) | (~both & ~(nan_got & nan_ref)) | (gap > TOL * scale)
    return int(bad.sum()), ref.size


def mismatch_share(program, reference) -> float:
    """The share of the checked members' stored values (every store,
    variable, year and cell) that disagree with the reference's.
    ``program`` and ``reference``: ``store -> var -> (rows, years, nx)``."""
    bad, total = map(sum, zip(*[_disagree(program[s][v], reference[s][v])
                                for s in STORES for v in reference[s]]))
    return bad / total


def study_mismatch(program, reference) -> float:
    """The share of an escape-rate study's checked values that disagree with
    the reference's: the members' yearly ice areas and labels (which
    attractor a member is nearer: a label agrees only where it is equal),
    their weather's last value, their final state (each field apart) and the
    attractors' reference areas."""
    got, want = np.asarray(program["labels"]), np.asarray(reference["labels"])
    pairs = [(program[k], reference[k]) for k in ("areas", "eta", "area_ab")]
    pairs += [(program["state"][k], reference["state"][k]) for k in reference["state"]]
    bad, total = map(sum, zip(*[_disagree(g, r) for g, r in pairs]))
    bad += int((got != want).sum()) if got.shape == want.shape else want.size
    return bad / (total + want.size)
