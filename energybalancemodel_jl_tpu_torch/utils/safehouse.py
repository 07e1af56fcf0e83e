"""Safehouse — a session value store protecting results from being overwritten.

Rebuild of the reference's REPL value-preservation subsystem
(EnergyBalanceModel.jl src/utilities.jl:58-124,281-375): values are deep-copied into
a ``Safehouse`` as ``Refugee`` records identified by a UUID-derived 32-bit id
and a timezone-aware timestamp, retrievable by id or by variable name.

The reference keys safehouses by Julia module; here safehouses are keyed by an
arbitrary namespace object (default: a global session namespace).
"""
from __future__ import annotations

import copy
import datetime
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List

__all__ = ["Refugee", "Safehouse", "safehouse", "house", "retrieve", "unique_id", "reprhex"]


def unique_id() -> int:
    """32-bit unique id derived from a UUID, mirroring
    ``unique_id() = UInt32(UUIDs.uuid1().value >> 96)``
    (EnergyBalanceModel.jl src/utilities.jl:378)."""
    return uuid.uuid1().int >> 96


def reprhex(value: int) -> str:
    """Hex repr without the ``0x`` prefix (EnergyBalanceModel.jl src/utilities.jl:379)."""
    return f"{value:08x}"


@dataclass
class Refugee:
    """A housed value (rebuild of ``Refugee`` EnergyBalanceModel.jl src/utilities.jl:58-68)."""

    varname: str
    id: int
    housed: datetime.datetime
    val: Any

    def __getitem__(self, _ignored=()) -> Any:
        return self.val

    @property
    def value(self) -> Any:
        return self.val

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"Refugee({self.varname}#{reprhex(self.id)} housed at {self.housed.isoformat()})"


@dataclass
class Safehouse:
    """Holds refugees by id with a per-variable index
    (rebuild of ``Safehouse`` EnergyBalanceModel.jl src/utilities.jl:94-103)."""

    variables: Dict[str, List[int]] = field(default_factory=dict)
    refugees: Dict[int, Refugee] = field(default_factory=dict)

    def __repr__(self):  # pragma: no cover - cosmetic
        parts = ", ".join(f"{len(ids)}@{v}" for v, ids in self.variables.items())
        return f"Safehouse({parts})"


# Keyed by id(namespace); the namespace itself is kept alive alongside its
# safehouse so a recycled id can never alias a dead namespace's store.
_SESSION_SAFEHOUSES: Dict[int, tuple] = {}
_DEFAULT_KEY = 0


def safehouse(namespace: Any = None) -> Safehouse:
    """Create or fetch the safehouse for ``namespace`` (default: the global
    session safehouse). Mirrors ``safehouse(modu, name)``
    (EnergyBalanceModel.jl src/utilities.jl:295-311)."""
    key = _DEFAULT_KEY if namespace is None else id(namespace)
    if key not in _SESSION_SAFEHOUSES:
        _SESSION_SAFEHOUSES[key] = (namespace, Safehouse())
    return _SESSION_SAFEHOUSES[key][1]


def house(name: str, value: Any, sh: Safehouse | None = None) -> Refugee:
    """Deep-copy ``value`` into the safehouse under ``name``; returns the
    :class:`Refugee`. Mirrors ``house!`` (EnergyBalanceModel.jl src/utilities.jl:332-338).
    """
    if sh is None:
        sh = safehouse()
    refugee = Refugee(
        varname=name,
        id=unique_id(),
        housed=datetime.datetime.now().astimezone(),
        val=copy.deepcopy(value),
    )
    sh.variables.setdefault(name, []).append(refugee.id)
    sh.refugees[refugee.id] = refugee
    return refugee


def retrieve(key, sh: Safehouse | None = None):
    """Retrieve by 32-bit id (single :class:`Refugee`) or by variable name
    (list of refugees). Mirrors ``retrieve``
    (EnergyBalanceModel.jl src/utilities.jl:373-375)."""
    if sh is None:
        sh = safehouse()
    if isinstance(key, str):
        return [sh.refugees[i] for i in sh.variables[key]]
    return sh.refugees[key]
