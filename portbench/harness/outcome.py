"""What a traffic kind is given and what it hands back."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch

from .trace import Trace


@dataclasses.dataclass
class Run:
    """One run's settings: the seed, the window's length, whether a stretch
    of it is traced, the device, and the process's start on
    ``time.perf_counter``'s clock (set-up counts from there)."""

    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float


@dataclasses.dataclass
class Check:
    """One number compared with the plain reference, and its limit: the
    run is correct when every value is at most its limit (NaN never is)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return not math.isnan(self.value) and self.value <= self.limit


@dataclasses.dataclass
class LayerContext:
    """What the per-layer metric readers read: the cell's configuration and
    traffic, the traced stretch (``items`` calls or steps, ``window_s`` long
    by the host's clock) with its device trace, the program's counters over
    the same stretch, and the rest of the window, untraced (``rest_items``
    in ``rest_s``)."""

    config: Dict[str, Any]
    traffic: Dict[str, Any]
    items: int
    window_s: float
    trace: Optional[Trace]
    counters: Dict[str, Any]
    rest_items: int = 0
    rest_s: float = 0.0


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: List[Check]
    device: Dict[str, Any]
    layers: Optional[LayerContext] = None

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def nearest_rank(values: List[float], q: float) -> float:
    """The ``q``-quantile of ``values`` by nearest rank: the smallest value
    with at least a share ``q`` of all values at or below it."""
    xs = sorted(values)
    return xs[max(0, math.ceil(q * len(xs)) - 1)]
