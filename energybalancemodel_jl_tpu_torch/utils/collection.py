"""Dot-access keyed collections (rebuild of EnergyBalanceModel.jl's
``Collection{V}``, ``src/infrastructure.jl:39-68``).

A ``dict`` subclass with attribute-style access. Unlike the JAX package's
twin it registers no pytree: PyTorch runs eagerly, so parameter and state
collections are plain dictionaries of tensors.
"""
from __future__ import annotations


class Collection(dict):
    """A ``dict`` with attribute-style access to its keys.

    Examples
    --------
    >>> parameters = Collection(D=0.6, A=193.0, B=2.1)
    >>> parameters.D
    0.6
    >>> parameters.F = 0.0
    >>> parameters["F"]
    0.0
    """

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(
                f"Collection has no entry {key!r} (keys: {sorted(self.keys())})"
            ) from None

    def __setattr__(self, key, value):
        self[key] = value

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError:
            raise AttributeError(key) from None

    def copy(self) -> "Collection":
        return Collection(self)

    def __repr__(self):  # pragma: no cover - cosmetic
        inner = ", ".join(f"{k}={v!r}" for k, v in sorted(self.items()))
        return f"Collection({inner})"
