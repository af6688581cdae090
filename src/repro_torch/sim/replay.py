"""Trace-driven replay of a tuned spec over a simulated fleet.

:func:`replay` runs one tuned :class:`~repro.mpc.api.MPCSpec` against an
:class:`~repro.sim.trace.ArrivalTrace` on a :class:`~repro.sim.devices
.FleetModel` — no JAX in the loop, just the event calendar and the cost
model's own arithmetic.  The structure mirrors the live stack exactly:

* **admission** — waves are sized by the engine's shared
  :func:`repro.mpc.engine.wave_width` /
  :func:`repro.mpc.engine._next_wave` formulas (FIFO within the group,
  one wave in flight: the engine's serial dispatch);
* **wave time** — the per-slot triples of :func:`repro.mpc.workers
  .slot_times` evaluated on the fleet's *true* pool, per-draw jitter
  applied, worst alive slot wins, times the backend's
  :func:`repro.mpc.workers.dispatch_waves` serialization — the same
  formula :func:`repro.mpc.workers.modeled_makespan` reduces, so
  predicted-vs-replayed divergence is calibration error by construction;
* **attrition** — dead placed devices become phase-3 dropout until the
  alive placed count falls below the (verified) quorum, then the group
  re-places on the healthy roster (the engine's escalation, counted in
  ``replans``); below quorum with no viable re-placement, remaining
  requests fail — isolated, never silent;
* **Byzantine** — placed liars under an adversary budget are caught at
  decode (``corrections``), evicted (``evictions``) and survived; liars
  past the budget fail the wave's requests; liars with *no* budget
  corrupt silently (``undetected_corruptions`` — the number the
  divergence report surfaces).

Every wave records per-device :class:`~repro.sim.trace.PhaseSample`
rows, so a replay's trace feeds :mod:`repro.sim.calibrate` exactly like
a live engine's recorder does.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..mpc.autotune import DEFAULT_COST, CostModel
from ..mpc.engine import WAVE_SCALARS, _next_wave, wave_width
from ..mpc.workers import dispatch_waves, slot_scalars, slot_times
from .devices import PHASES, FleetModel
from .events import Simulator
from .trace import ArrivalTrace, PhaseRecorder, PhaseSample


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    """Knobs mirroring the live serving stack's admission/backend shape.

    ``max_batch`` / ``wave_scalars`` / ``inflight`` are the engine's
    wave-admission knobs (defaults match :class:`~repro.mpc.engine
    .MPCEngine`); ``axis_size`` is the sharded mesh axis (``None``: all
    N lanes parallel, the local/batched model).
    """

    max_batch: int = 64
    wave_scalars: Optional[int] = WAVE_SCALARS
    inflight: Optional[int] = None
    axis_size: Optional[int] = None

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(
                f"max_batch must be >= 1, got {self.max_batch}")


@dataclasses.dataclass(frozen=True)
class ReplayReport:
    """What one replay did: the makespan, per-request completions, and
    the fault/escalation counters the live engine would have reported."""

    makespan_us: float
    completions: Dict[int, float]        # rid → completion time (µs)
    failed: Dict[int, str]               # rid → reason
    waves: int
    replans: int
    corrections: int
    evictions: int
    undetected_corruptions: int
    device_busy_us: Dict[int, float]     # roster id → busy µs
    samples: Tuple[PhaseSample, ...]

    @property
    def served(self) -> int:
        return len(self.completions)

    def utilization(self, device: int) -> float:
        """Busy fraction of one device over the replay's makespan."""
        if self.makespan_us <= 0:
            return 0.0
        return self.device_busy_us.get(int(device), 0.0) / self.makespan_us

    def describe(self) -> Dict:
        return {"makespan_us": self.makespan_us, "served": self.served,
                "failed": len(self.failed), "waves": self.waves,
                "replans": self.replans, "corrections": self.corrections,
                "evictions": self.evictions,
                "undetected_corruptions": self.undetected_corruptions}


class _ReplayState:
    """Mutable loop state shared by the event handlers."""

    def __init__(self, spec, cost, fleet, config, recorder):
        n = spec.n_workers
        self.spec = spec
        self.cost = cost
        self.fleet = fleet
        self.config = config
        self.recorder = recorder
        #: believed roster (cost-model recalibrated) — drives RE-placement
        self.believed = cost.recalibrated_pool(spec.pool)
        placement = spec.effective_placement
        if placement is None:
            placement = self.believed.place(n, cost)
        self.placement: Tuple[int, ...] = tuple(int(d) for d in placement)
        self.threshold = (spec.t * spec.t + spec.z
                          + 2 * spec.adversaries)
        self.width = wave_width(spec, max_batch=config.max_batch,
                                wave_scalars=config.wave_scalars,
                                inflight=config.inflight)
        self.pending: "deque[int]" = deque()    # rids, one entry per block
        self.blocks_left: Dict[int, int] = {}
        self.completions: Dict[int, float] = {}
        self.failed: Dict[int, str] = {}
        self.busy = False
        self.waves = 0
        self.replans = 0
        self.corrections = 0
        self.evictions = 0
        self.undetected = 0
        self.device_busy: Dict[int, float] = {}

    # ------------------------------------------------------- escalation
    def _ensure_placement(self) -> bool:
        """True when the group can serve: enough alive placed devices, or
        a successful re-placement on the healthy roster."""
        alive = [d for d in self.placement if self.fleet.is_alive(d)]
        if len(alive) >= self.threshold:
            return True
        healthy = list(self.fleet.healthy_devices())
        if len(healthy) >= self.spec.n_workers:
            self.placement = tuple(int(d) for d in self.believed.place(
                self.spec.n_workers, self.cost, within=healthy))
            self.replans += 1
            return True
        return False

    def _fail_pending(self, reason: str) -> None:
        for rid in set(self.pending):
            self.failed[rid] = reason
            self.blocks_left.pop(rid, None)
        self.pending.clear()

    # ------------------------------------------------------------- waves
    def start_wave(self, sim: Simulator) -> None:
        if self.busy or not self.pending:
            return
        if not self._ensure_placement():
            self._fail_pending(
                f"fleet below the verified quorum "
                f"t²+z+2a={self.threshold} with no viable re-placement")
            return
        spec, fleet = self.spec, self.fleet
        take = _next_wave(len(self.pending), self.width)
        lanes = [self.pending.popleft() for _ in range(take)]
        wave_id = self.waves
        self.waves += 1

        # liars among the placed, alive devices (DESIGN.md §9)
        liars = [d for d in self.placement
                 if fleet.is_alive(d) and fleet.is_liar(d)]
        budget = spec.adversaries
        wave_failed: Optional[str] = None
        if liars and budget == 0:
            self.undetected += take       # silent corruption: no MACs
        elif len(liars) > budget > 0:
            wave_failed = (f"adversary budget exhausted: {len(liars)} "
                           f"corrupted shares detected > budget a={budget}")
        elif liars:
            self.corrections += len(liars) * take
            for d in liars:               # caught liars ARE attrition
                fleet.fail(d)
                self.evictions += 1

        times = slot_times(spec.m, spec.s, spec.t, spec.z, spec.n_workers,
                           self.cost, fleet.true_pool, self.placement,
                           adversaries=spec.adversaries)
        raw = slot_scalars(spec.m, spec.s, spec.t, spec.z, spec.n_workers,
                           len(self.placement),
                           adversaries=spec.adversaries)
        worst = 0.0
        for slot, dev in enumerate(self.placement):
            if not fleet.is_alive(dev) and dev not in liars:
                continue                  # phase-3 dropout: never waited on
            slot_us = 0.0
            for pi, phase in enumerate(PHASES):
                noise = fleet.noise(dev, wave_id, phase)
                us = times[slot][pi] * noise * take
                slot_us += us
                self.recorder.record(
                    device=dev, klass=fleet.pool.workers[dev].name,
                    phase=phase, scalars=raw[slot][pi] * take, us=us,
                    lanes=take)
            self.device_busy[dev] = self.device_busy.get(dev, 0.0) + slot_us
            worst = max(worst, slot_us)
        d_waves = dispatch_waves(spec.n_workers, self.config.axis_size)
        wave_us = d_waves * (worst + self.cost.dispatch)
        self.busy = True
        sim.schedule(sim.now + wave_us, "wave_done",
                     (tuple(lanes), wave_failed))

    def finish_wave(self, sim: Simulator, lanes: Tuple[int, ...],
                    wave_failed: Optional[str]) -> None:
        self.busy = False
        for rid in lanes:
            if rid in self.failed:
                continue
            if wave_failed is not None:
                self.failed[rid] = wave_failed
                self.blocks_left.pop(rid, None)
                continue
            self.blocks_left[rid] -= 1
            if self.blocks_left[rid] == 0:
                del self.blocks_left[rid]
                self.completions[rid] = sim.now
        self.start_wave(sim)


def replay(spec, trace: ArrivalTrace, *,
           cost: Optional[CostModel] = None,
           fleet: Optional[FleetModel] = None,
           config: Optional[ReplayConfig] = None,
           recorder: Optional[PhaseRecorder] = None) -> ReplayReport:
    """Replay ``trace`` against ``spec`` on ``fleet``; deterministic for
    a fixed fleet seed (the only randomness source).

    ``cost`` is the *believed* model (weights + class multipliers) —
    it prices the waves and steers re-placements; ``fleet`` is the
    ground truth (defaults to the ideal fleet: believed == true, the
    prediction baseline).  ``recorder`` collects the per-device phase
    samples (a fresh one when omitted; always included in the report).
    """
    if spec.pool is None:
        raise ValueError(
            "replay requires a spec carrying a WorkerPool "
            "(tune(pool=...)); an int worker budget has no devices to "
            "simulate")
    cm = DEFAULT_COST if cost is None else cost
    fl = FleetModel(spec.pool) if fleet is None else fleet
    if len(fl.pool.workers) != len(spec.pool.workers):
        raise ValueError(
            f"fleet roster has {len(fl.pool.workers)} devices but the "
            f"spec's pool has {len(spec.pool.workers)}")
    cfg = ReplayConfig() if config is None else config
    rec = PhaseRecorder() if recorder is None else recorder

    state = _ReplayState(spec, cm, fl, cfg, rec)
    sim = Simulator()

    def on_arrival(s: Simulator, ev) -> None:
        arrival = ev.payload
        state.blocks_left[arrival.rid] = arrival.blocks
        state.pending.extend([arrival.rid] * arrival.blocks)
        state.start_wave(s)

    def on_fault(s: Simulator, ev) -> None:
        f = ev.payload
        if f.kind == "fail":
            state.fleet.fail(f.device)
        else:
            state.fleet.corrupt(f.device)

    def on_wave_done(s: Simulator, ev) -> None:
        lanes, wave_failed = ev.payload
        state.finish_wave(s, lanes, wave_failed)

    sim.on("arrival", on_arrival)
    sim.on("fault", on_fault)
    sim.on("wave_done", on_wave_done)
    # faults first: a fault at time T describes the fleet's state BEFORE
    # any arrival at T (ties break by insertion order), so a t=0 schedule
    # is an initial condition, not a mid-wave surprise
    for f in trace.faults:
        sim.schedule(f.at_us, "fault", f)
    for a in trace.arrivals:
        sim.schedule(a.at_us, "arrival", a)
    sim.run()

    makespan = max(state.completions.values(), default=0.0)
    return ReplayReport(
        makespan_us=makespan, completions=dict(state.completions),
        failed=dict(state.failed), waves=state.waves,
        replans=state.replans, corrections=state.corrections,
        evictions=state.evictions,
        undetected_corruptions=state.undetected,
        device_busy_us=dict(state.device_busy),
        samples=tuple(rec.samples))


def predict(spec, trace: ArrivalTrace, *,
            cost: Optional[CostModel] = None,
            config: Optional[ReplayConfig] = None) -> ReplayReport:
    """The model's prediction for ``trace``: the *same* replay code path
    on the ideal fleet — believed (cost-recalibrated) rates as truth,
    zero jitter, faults stripped.  At a perfectly calibrated fleet,
    ``predict(...).makespan_us == replay(...).makespan_us`` exactly;
    the divergence report measures how far reality drifts
    (DESIGN.md §11)."""
    cm = DEFAULT_COST if cost is None else cost
    fleet = FleetModel(cm.recalibrated_pool(spec.pool))
    return replay(spec, trace.without_faults(), cost=cm, fleet=fleet,
                  config=config)
