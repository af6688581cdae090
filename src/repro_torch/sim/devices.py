"""The fleet truth model: what devices *actually* run like.

A :class:`~repro.mpc.workers.WorkerPool` carries the *believed* rates
(hand-set, or previously calibrated).  :class:`FleetModel` wraps it with
the ground truth the simulator executes against: per-class planted
(ξ, σ, ζ) rate multipliers (the quantity calibration must recover) and
per-draw lognormal jitter.  Noise draws are keyed by
``(seed, device, draw_id, phase)`` — *order-independent* determinism, so
two replays that visit waves in the same simulated order produce
bit-identical timings, and a planted multiplier is recoverable as the
median over jittered samples (lognormal noise has median 1).
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence, Set

import numpy as np

from ..mpc.workers import WorkerPool

PHASES = ("compute", "storage", "exchange")


class FleetModel:
    """Ground truth for a simulated fleet over a roster.

    ``class_multipliers`` maps class names to the true (ξ, σ, ζ) rate
    factors relative to the pool's believed rates (``None``: the pool is
    already the truth — the *prediction* fleet).  ``jitter`` is the
    lognormal σ of per-draw noise (0: fully deterministic timings).
    """

    def __init__(self, pool: WorkerPool, *,
                 class_multipliers: Optional[Mapping[str, Sequence[float]]]
                 = None,
                 jitter: float = 0.0, seed: int = 0):
        if jitter < 0:
            raise ValueError(f"jitter must be >= 0, got {jitter}")
        self.pool = pool
        self.class_multipliers = (dict(class_multipliers)
                                  if class_multipliers else {})
        #: the roster as it actually performs — placements stay indexed
        #: into the same roster, so the believed and the true pool are
        #: interchangeable everywhere a placement is evaluated
        self.true_pool = (pool.recalibrated(self.class_multipliers)
                          if self.class_multipliers else pool)
        self.jitter = float(jitter)
        self.seed = int(seed)
        self._dead: Set[int] = set()
        self._liars: Set[int] = set()

    # ------------------------------------------------------------- state
    def fail(self, device: int) -> None:
        self._dead.add(int(device))
        self._liars.discard(int(device))  # a dead liar lies no more

    def corrupt(self, device: int) -> None:
        if int(device) not in self._dead:
            self._liars.add(int(device))

    def is_alive(self, device: int) -> bool:
        return int(device) not in self._dead

    def is_liar(self, device: int) -> bool:
        return int(device) in self._liars

    def healthy_devices(self) -> Iterable[int]:
        """Alive roster ids (liars included — they look healthy until a
        verified decode catches them)."""
        return [d for d in range(len(self.pool.workers))
                if d not in self._dead]

    def alive_count(self) -> int:
        return len(self.pool.workers) - len(self._dead)

    # ------------------------------------------------------------- noise
    def noise(self, device: int, draw_id: int, phase: str) -> float:
        """One deterministic lognormal factor for ``(device, draw_id,
        phase)`` — median 1, independent of visit order."""
        if self.jitter == 0.0:
            return 1.0
        pi = PHASES.index(phase)
        rng = np.random.default_rng(
            (self.seed, int(device) + 1, int(draw_id), pi))
        return float(np.exp(rng.normal(0.0, self.jitter)))

    def describe(self) -> Dict:
        return {"devices": len(self.pool.workers),
                "dead": sorted(self._dead), "liars": sorted(self._liars),
                "jitter": self.jitter, "seed": self.seed,
                "class_multipliers": {
                    k: list(v) for k, v in self.class_multipliers.items()}}
