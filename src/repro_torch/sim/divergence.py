"""Predicted-vs-replayed divergence: the report and the CI gate.

The first layer that can say "the tuner is wrong" without running a
fleet: for each spec under test, :func:`repro.sim.replay.predict` gives
the cost model's makespan and :func:`repro.sim.replay.replay` the
simulated fleet's; their ratio should sit near 1 (the formulas are
shared by construction — drift measures calibration error and fleet
noise, not modeling skew), and across specs the *ranking* the model
claims (tuned placement beats capacity-oblivious) must survive replay.
:func:`gate` packages the canonical check — two specs over a skewed
≥1000-device fleet — for `benchmarks/run.py --sim-divergence` and CI.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from ..mpc.autotune import CostModel, tune
from ..mpc.workers import GATEWAY, PHONE, WorkerPool
from .devices import FleetModel
from .replay import ReplayConfig, ReplayReport, predict, replay
from .trace import ArrivalTrace


@dataclasses.dataclass(frozen=True)
class SpecDivergence:
    """One spec's predicted vs replayed makespan."""

    label: str
    predicted_us: float
    replayed_us: float

    @property
    def ratio(self) -> float:
        """replayed / predicted (1.0 = perfect calibration; inf when
        the model predicted zero but the replay did not)."""
        if self.predicted_us <= 0:
            return float("inf") if self.replayed_us > 0 else 1.0
        return self.replayed_us / self.predicted_us

    def within(self, tolerance: float) -> bool:
        """Ratio inside ``[1/(1+tol), 1+tol]`` — symmetric in log space,
        so over- and under-prediction are policed alike."""
        r = self.ratio
        return 1.0 / (1.0 + tolerance) <= r <= 1.0 + tolerance


@dataclasses.dataclass(frozen=True)
class DivergenceReport:
    """The gate's verdict: per-spec ratios + ranking agreement."""

    entries: Tuple[SpecDivergence, ...]
    tolerance: float
    ranking_agrees: bool

    @property
    def ok(self) -> bool:
        return (self.ranking_agrees
                and all(e.within(self.tolerance) for e in self.entries))

    def describe(self) -> Dict:
        return {
            "ok": self.ok, "tolerance": self.tolerance,
            "ranking_agrees": self.ranking_agrees,
            "entries": [
                {"label": e.label, "predicted_us": round(e.predicted_us, 2),
                 "replayed_us": round(e.replayed_us, 2),
                 "ratio": round(e.ratio, 4),
                 "within": e.within(self.tolerance)}
                for e in self.entries]}


def divergence_report(pairs: Sequence[Tuple[str, ReplayReport,
                                            ReplayReport]],
                      *, tolerance: float = 0.25) -> DivergenceReport:
    """Build the report from ``(label, predicted, replayed)`` triples.

    Ranking agreement compares the order of the first two entries (the
    canonical tuned-vs-oblivious pair); a single entry trivially agrees.
    """
    entries = tuple(
        SpecDivergence(label=label, predicted_us=pred.makespan_us,
                       replayed_us=rep.makespan_us)
        for label, pred, rep in pairs)
    ranking = True
    if len(entries) >= 2:
        a, b = entries[0], entries[1]
        ranking = ((a.predicted_us < b.predicted_us)
                   == (a.replayed_us < b.replayed_us))
    return DivergenceReport(entries=entries, tolerance=tolerance,
                            ranking_agrees=ranking)


def skewed_fleet_pool(devices: int = 1000,
                      fast_fraction: float = 0.04) -> WorkerPool:
    """The canonical skewed fleet: mostly phones, a thin gateway tier,
    phones first in roster order — so the capacity-oblivious identity
    placement lands on the slow class and the tuned placement has
    something real to win."""
    fast = max(8, int(devices * fast_fraction))
    return WorkerPool.of((PHONE, devices - fast), (GATEWAY, fast))


def gate(*, devices: int = 1000, requests: int = 24, z: int = 2,
         shape: Tuple[int, int, int] = (96, 96, 96),
         seed: int = 0, jitter: float = 0.02, tolerance: float = 0.25,
         cost: Optional[CostModel] = None,
         config: Optional[ReplayConfig] = None) -> DivergenceReport:
    """The CI divergence check (DESIGN.md §11).

    Tunes one spec over a skewed ``devices``-strong fleet, builds its
    capacity-oblivious twin (same code, identity placement on the slow
    roster prefix), replays both against a burst trace with mild jitter,
    and reports predicted-vs-replayed ratios + ranking agreement.
    Deterministic under ``seed``; fails (``report.ok`` False) when a
    ratio drifts past ``tolerance`` or the replay flips the ranking the
    cost model claimed.
    """
    cm = CostModel() if cost is None else cost
    pool = skewed_fleet_pool(devices)
    spec = tune(z=z, shape=shape, pool=pool, cost=cm).spec
    oblivious = dataclasses.replace(
        spec, placement=tuple(range(spec.n_workers)))
    trace = ArrivalTrace.burst(requests)
    pairs = []
    for label, sp in (("tuned", spec), ("oblivious", oblivious)):
        fleet = FleetModel(pool, jitter=jitter, seed=seed)
        rep = replay(sp, trace, cost=cm, fleet=fleet, config=config)
        pred = predict(sp, trace, cost=cm, config=config)
        pairs.append((label, pred, rep))
    return divergence_report(pairs, tolerance=tolerance)
