"""Fit per-`WorkerClass` (ξ, σ, ζ) multipliers from phase samples.

The closing of the loop (DESIGN.md §11): a replay (or a live engine via
its recorder hooks) produces :class:`~repro.sim.trace.PhaseSample` rows
— measured µs per device, phase and scalar count.  For each sample the
*believed* cost of the work is ``weight × scalars × rate`` (the cost
model's µs/scalar weight for the phase, times the roster's believed
per-resource rate of the device); the ratio ``us / believed`` is one
noisy estimate of the class's true-over-believed rate multiplier.  The
fit takes the **median** ratio per ``(class, phase)`` — lognormal
jitter has median 1, so planted multipliers are recovered exactly in
expectation, robustly against heavy-tailed stragglers (a mean would
chase them).

The result feeds both directions of the loop:

* :meth:`CostModel.with_class_multipliers` — the tuner now places and
  scores with measured rates;
* :meth:`WorkerPool.recalibrated` — a roster whose capacity vectors are
  measurement, not hand-set guesses.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from ..mpc.autotune import CostModel
from ..mpc.workers import WorkerPool
from .trace import PhaseSample

#: per-device phase → (CostModel weight attr, WorkerClass rate attr);
#: aggregate live phases (front/decode/fused) are NOT fitted per class —
#: they time all N workers in one program
PHASE_AXES = {
    "compute": ("computation", "compute"),
    "storage": ("storage", "storage"),
    "exchange": ("communication", "link"),
}


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """Fitted multipliers + the recalibrated model and roster."""

    multipliers: Dict[str, Tuple[float, float, float]]
    cost: CostModel
    pool: WorkerPool
    samples_used: int

    def describe(self) -> Dict:
        return {"samples_used": self.samples_used,
                "multipliers": {k: list(v)
                                for k, v in self.multipliers.items()}}


def fit_class_multipliers(
        samples: Iterable[PhaseSample], pool: WorkerPool,
        cost: Optional[CostModel] = None,
        *, min_samples: int = 3) -> Dict[str, Tuple[float, float, float]]:
    """Median-of-ratios fit: ``{class name: (ξ, σ, ζ) multipliers)}``.

    Only per-device samples with a positive believed cost contribute
    (aggregate ``device=-1`` engine samples and unknown phases are
    skipped).  A ``(class, phase)`` cell with fewer than ``min_samples``
    ratios keeps multiplier 1.0 — too little evidence to move a rate.
    Classes with no evidence at all are absent from the result (so
    :meth:`WorkerPool.recalibrated` leaves them untouched).
    """
    cm = CostModel() if cost is None else cost
    ratios: Dict[Tuple[str, int], list] = {}
    for s in samples:
        axes = PHASE_AXES.get(s.phase)
        if axes is None or s.device < 0:
            continue
        if not 0 <= s.device < len(pool.workers):
            continue
        w = pool.workers[s.device]
        if w.name != s.klass:   # stale trace vs roster: don't mis-attribute
            continue
        believed = (getattr(cm, axes[0]) * s.scalars
                    * getattr(w, axes[1]))
        if believed <= 0 or s.us < 0:
            continue
        pi = list(PHASE_AXES).index(s.phase)
        ratios.setdefault((w.name, pi), []).append(s.us / believed)
    out: Dict[str, Tuple[float, float, float]] = {}
    for name in {k for k, _ in ratios}:
        mult = [1.0, 1.0, 1.0]
        for pi in range(3):
            cell = ratios.get((name, pi), [])
            if len(cell) >= min_samples:
                mult[pi] = float(np.median(cell))
        out[name] = tuple(mult)
    return out


def calibrate(samples: Iterable[PhaseSample], pool: WorkerPool,
              cost: Optional[CostModel] = None,
              *, min_samples: int = 3) -> CalibrationResult:
    """One-call loop closure: fit multipliers, return the recalibrated
    :class:`~repro.mpc.autotune.CostModel` (for the tuner) and
    :class:`~repro.mpc.workers.WorkerPool` (for anything reading
    capacity vectors directly)."""
    cm = CostModel() if cost is None else cost
    samples = list(samples)
    mult = fit_class_multipliers(samples, pool, cm,
                                 min_samples=min_samples)
    return CalibrationResult(
        multipliers=mult,
        cost=cm.with_class_multipliers(mult),
        pool=pool.recalibrated(mult),
        samples_used=len(samples))
