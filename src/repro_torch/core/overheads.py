"""Per-worker computation / storage / communication overheads (Cor. 8-10).

The paper's Fig. 3 plots these for every scheme using that scheme's own ``N``
with the same structural formulas (the phases are identical across the CMPC
family; only the required worker count differs).  All formulas count *scalars*
(Fig. 3 assumes 1 byte per stored/transmitted scalar).
"""
from __future__ import annotations

import dataclasses

from .worker_counts import SCHEMES


@dataclasses.dataclass(frozen=True)
class Overheads:
    computation: float   # ξ: scalar multiplications per worker  (Cor. 8)
    storage: float       # σ: scalars stored per worker          (Cor. 9)
    communication: float # ζ: scalars exchanged among workers    (Cor. 10)


def computation_per_worker(m: int, s: int, t: int, z: int, n: int) -> float:
    """ξ = m³/(st²) + m² + N(t² + z - 1)·m²/t²  -- eq. (15)."""
    return m**3 / (s * t * t) + m**2 + n * (t * t + z - 1) * m**2 / (t * t)


def storage_per_worker(m: int, s: int, t: int, z: int, n: int) -> float:
    """σ = (2N + z + 1)·m²/t² + 2m²/(st) + t²  -- eq. (16)."""
    return (2 * n + z + 1) * m**2 / (t * t) + 2 * m**2 / (s * t) + t * t


def communication_total(m: int, s: int, t: int, z: int, n: int) -> float:
    """ζ = N(N-1)·m²/t²  -- eq. (17) (phase-2 worker↔worker exchange)."""
    return n * (n - 1) * m**2 / (t * t)


def overheads(m: int, s: int, t: int, z: int, n: int) -> Overheads:
    return Overheads(
        computation=computation_per_worker(m, s, t, z, n),
        storage=storage_per_worker(m, s, t, z, n),
        communication=communication_total(m, s, t, z, n),
    )


def scheme_overheads(m: int, s: int, t: int, z: int) -> dict:
    """Fig. 3 rows: overheads for every scheme at its own worker count."""
    return {
        name: overheads(m, s, t, z, fn(s, t, z))
        for name, fn in SCHEMES.items()
    }
