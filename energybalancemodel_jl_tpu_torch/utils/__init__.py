"""Generic utilities (rebuild of EnergyBalanceModel.jl ``src/utilities.jl``)."""
from .collection import Collection
from .numerics import (condset, crossmean, hemispheric_mean, nan_to_zero, np_hemispheric_mean,
                       zeroref)
from .persistent import persistent
from .progress import Progress, update
from .safehouse import Refugee, Safehouse, house, reprhex, retrieve, safehouse, unique_id

__all__ = ["Collection", "Progress", "update", "Refugee", "Safehouse", "safehouse",
           "house", "retrieve", "unique_id", "reprhex", "persistent", "crossmean",
           "hemispheric_mean", "np_hemispheric_mean", "condset", "zeroref", "nan_to_zero"]
