"""Trace-driven fleet simulation + cost-model calibration (DESIGN.md §11).

The paper's argument is a cost model — Cor. 8–10 predict per-worker
computation/storage/communication, and the tuner picks ``(scheme, s, t,
λ)`` plus a device placement by those predictions.  Nothing in the live
stack validates them at fleet scale: a tuner regression (wrong ranking,
wrong placement) is invisible until a benchmark happens to catch it.
This package is the validation layer:

* :mod:`repro.sim.events` — a deterministic discrete-event calendar
  (no JAX in the hot loop; a replay of thousands of devices is pure
  Python arithmetic over the cost model's own per-slot formula);
* :mod:`repro.sim.trace` — the trace schema: request arrivals, fleet
  attrition/corruption schedules, and the per-device phase-timing
  samples both the simulator and the live engine's recorder hooks emit;
* :mod:`repro.sim.devices` — the fleet truth model: per-class planted
  rate multipliers + per-draw lognormal jitter over a
  :class:`~repro.mpc.workers.WorkerPool` roster;
* :mod:`repro.sim.replay` — replays a tuned :class:`~repro.mpc.api
  .MPCSpec` against a trace through the engine's *own* wave-admission
  formulas (``wave_width``/``_next_wave``) and the pool's *own* per-slot
  makespan formula (``slot_times``), so model-vs-replay divergence
  measures calibration error, never formula drift;
* :mod:`repro.sim.calibrate` — fits per-``WorkerClass`` (ξ, σ, ζ)
  multipliers from recorded phase samples and feeds them back into
  :class:`~repro.mpc.autotune.CostModel` / :class:`~repro.mpc.workers
  .WorkerPool`;
* :mod:`repro.sim.divergence` — the predicted-vs-replayed report and
  the CI gate that fails when the ratio drifts past tolerance or the
  tuned-vs-oblivious ranking flips.
"""
from .calibrate import CalibrationResult, calibrate, fit_class_multipliers
from .devices import FleetModel
from .divergence import DivergenceReport, SpecDivergence, divergence_report, gate
from .events import Event, EventQueue, Simulator
from .replay import ReplayConfig, ReplayReport, predict, replay
from .trace import Arrival, ArrivalTrace, FleetEvent, PhaseRecorder, PhaseSample

__all__ = [
    "Arrival", "ArrivalTrace", "CalibrationResult", "DivergenceReport",
    "Event", "EventQueue", "FleetEvent", "FleetModel", "PhaseRecorder",
    "PhaseSample", "ReplayConfig", "ReplayReport", "Simulator",
    "SpecDivergence", "calibrate", "divergence_report",
    "fit_class_multipliers", "gate", "predict", "replay",
]
