"""Generic utilities (rebuild of EnergyBalanceModel.jl ``src/utilities.jl``)."""
from .collection import Collection
from .progress import Progress, update

__all__ = ["Collection", "Progress", "update"]
