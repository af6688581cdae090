"""Trace schema: arrivals, fleet faults, and phase-timing samples.

Three record types flow through the simulator (DESIGN.md §11):

* :class:`Arrival` — one request entering the system (synthetic via the
  :class:`ArrivalTrace` constructors, or recorded from a live queue);
* :class:`FleetEvent` — a device failing or turning Byzantine at a
  point in simulated time (attrition/corruption schedules);
* :class:`PhaseSample` — one timed phase execution: *who* (device +
  class), *what* (phase name), *how much work* (scalar count) and *how
  long* (µs).  Both the simulator's replay loop and the live
  ``MPCEngine``/``ProtocolStages.timed`` recorder hooks emit these
  through one :class:`PhaseRecorder`, so the calibration fit
  (:mod:`repro.sim.calibrate`) is source-agnostic.

All three round-trip through JSON so traces can be saved from one run
and replayed in another (or in CI).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

TRACE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request: arrival time, id, and its coded-block count."""

    at_us: float
    rid: int
    blocks: int = 1

    def __post_init__(self):
        if self.at_us < 0:
            raise ValueError(f"arrival time must be >= 0, got {self.at_us}")
        if self.blocks < 1:
            raise ValueError(f"blocks must be >= 1, got {self.blocks}")


@dataclasses.dataclass(frozen=True)
class FleetEvent:
    """A device leaving the fleet (``fail``) or turning liar
    (``corrupt``) at ``at_us``."""

    at_us: float
    device: int
    kind: str = "fail"

    def __post_init__(self):
        if self.kind not in ("fail", "corrupt"):
            raise ValueError(
                f"fleet event kind must be fail|corrupt, got {self.kind!r}")
        if self.at_us < 0:
            raise ValueError(f"event time must be >= 0, got {self.at_us}")


@dataclasses.dataclass(frozen=True)
class ArrivalTrace:
    """An immutable arrival + fault schedule.

    Construct synthetically (:meth:`poisson`, :meth:`uniform`,
    :meth:`burst`), decorate with faults (:meth:`with_faults`), or load
    a recorded schedule (:meth:`load`).  Arrival times are µs.
    """

    arrivals: Tuple[Arrival, ...]
    faults: Tuple[FleetEvent, ...] = ()

    def __post_init__(self):
        ats = [a.at_us for a in self.arrivals]
        if ats != sorted(ats):
            raise ValueError("arrivals must be time-sorted")

    # ------------------------------------------------------- constructors
    @classmethod
    def burst(cls, n: int, *, blocks: int = 1) -> "ArrivalTrace":
        """``n`` requests all arriving at t=0 — the closed-queue batch
        workload (every bench pair's shape)."""
        return cls(tuple(Arrival(0.0, rid, blocks) for rid in range(n)))

    @classmethod
    def uniform(cls, n: int, gap_us: float, *,
                blocks: int = 1) -> "ArrivalTrace":
        """``n`` requests with a fixed inter-arrival gap."""
        if gap_us < 0:
            raise ValueError(f"gap_us must be >= 0, got {gap_us}")
        return cls(tuple(Arrival(rid * gap_us, rid, blocks)
                         for rid in range(n)))

    @classmethod
    def poisson(cls, n: int, rate_rps: float, *, seed: int = 0,
                blocks: int = 1) -> "ArrivalTrace":
        """``n`` requests with exponential inter-arrivals at
        ``rate_rps`` requests/second (deterministic under ``seed``)."""
        if rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
        rng = np.random.default_rng(seed)
        gaps = rng.exponential(1e6 / rate_rps, size=n)
        ats = np.cumsum(gaps) - gaps[0]  # first arrival at t=0
        return cls(tuple(Arrival(float(at), rid, blocks)
                         for rid, at in enumerate(ats)))

    # --------------------------------------------------------- decorators
    def with_faults(self, *faults: FleetEvent) -> "ArrivalTrace":
        """This trace plus an attrition/corruption schedule."""
        allf = sorted(self.faults + tuple(faults),
                      key=lambda f: (f.at_us, f.device))
        return dataclasses.replace(self, faults=tuple(allf))

    def without_faults(self) -> "ArrivalTrace":
        """The fault-free twin — what the *prediction* replays
        (:func:`repro.sim.replay.predict`): same arrivals, ideal fleet."""
        return dataclasses.replace(self, faults=())

    # ------------------------------------------------------------ persist
    def to_json(self) -> Dict:
        return {
            "version": TRACE_VERSION,
            "arrivals": [dataclasses.asdict(a) for a in self.arrivals],
            "faults": [dataclasses.asdict(f) for f in self.faults],
        }

    @classmethod
    def from_json(cls, doc: Dict) -> "ArrivalTrace":
        if doc.get("version") != TRACE_VERSION:
            raise ValueError(
                f"unsupported trace version {doc.get('version')!r} "
                f"(expected {TRACE_VERSION})")
        return cls(
            arrivals=tuple(Arrival(**a) for a in doc.get("arrivals", [])),
            faults=tuple(FleetEvent(**f) for f in doc.get("faults", [])))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "ArrivalTrace":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def __len__(self) -> int:
        return len(self.arrivals)


@dataclasses.dataclass(frozen=True)
class PhaseSample:
    """One timed phase execution.

    ``device`` is a roster id (−1: fleet-aggregate, e.g. one vmapped
    engine wave over all N workers); ``klass`` the
    :class:`~repro.mpc.workers.WorkerClass` name the device belongs to;
    ``phase`` one of the simulator's per-device phases (``compute`` /
    ``storage`` / ``exchange``) or a live program stage (``front`` /
    ``decode`` / ``fused`` / …); ``scalars`` the Cor. 8–10 work unit
    count the execution covered; ``us`` measured wall time; ``lanes``
    the vmap width it served.
    """

    device: int
    klass: str
    phase: str
    scalars: float
    us: float
    lanes: int = 1


class PhaseRecorder:
    """The duck-typed ``record(**kw)`` sink engine hooks and the
    simulator feed (so :mod:`repro.mpc` never imports :mod:`repro.sim`).

    Collects :class:`PhaseSample` rows; :meth:`by_class` groups them for
    the calibration fit; JSON save/load round-trips recorded traces.
    """

    def __init__(self):
        self.samples: List[PhaseSample] = []

    def record(self, *, device: int, klass: str, phase: str,
               scalars: float, us: float, lanes: int = 1) -> None:
        self.samples.append(PhaseSample(
            device=int(device), klass=str(klass), phase=str(phase),
            scalars=float(scalars), us=float(us), lanes=int(lanes)))

    def __len__(self) -> int:
        return len(self.samples)

    def by_class(self, phases: Optional[Sequence[str]] = None
                 ) -> Dict[Tuple[str, str], List[PhaseSample]]:
        """Samples grouped by ``(klass, phase)``, optionally filtered to
        a phase subset (the calibration fit passes the per-device
        simulator phases)."""
        out: Dict[Tuple[str, str], List[PhaseSample]] = {}
        for s in self.samples:
            if phases is not None and s.phase not in phases:
                continue
            out.setdefault((s.klass, s.phase), []).append(s)
        return out

    # ------------------------------------------------------------ persist
    def to_json(self) -> Dict:
        return {"version": TRACE_VERSION,
                "samples": [dataclasses.asdict(s) for s in self.samples]}

    @classmethod
    def from_json(cls, doc: Dict) -> "PhaseRecorder":
        if doc.get("version") != TRACE_VERSION:
            raise ValueError(
                f"unsupported sample version {doc.get('version')!r} "
                f"(expected {TRACE_VERSION})")
        rec = cls()
        for s in doc.get("samples", []):
            rec.samples.append(PhaseSample(**s))
        return rec

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)

    @classmethod
    def load(cls, path: str) -> "PhaseRecorder":
        with open(path) as f:
            return cls.from_json(json.load(f))
