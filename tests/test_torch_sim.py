"""The fleet simulator on the port (``repro_torch.sim``): every case of
``tests/test_sim.py`` against the port (engines on ``device="cpu"``, int
keys for ``jax.random`` keys), then the port held against the JAX package
on the same inputs: ``predict``/``replay`` reports at zero jitter on
those traces (fault traces included), calibrated multipliers from the same
samples, the divergence gate's report, ``FaultInjector.to_fleet_events``
and the ``(phase, scalars, klass)`` sequence ``ProtocolStages.timed``
records for the same calls."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sim as j_sim
from repro.mpc import autotune as j_autotune
from repro.mpc import byzantine as j_byz
from repro.mpc import workers as j_workers
from repro.mpc.protocol import AGECMPCProtocol as JProto
from repro.sim import divergence as j_div
from repro.sim import trace as j_trace
from repro_torch.mpc.autotune import (
    CostModel,
    DEFAULT_COST,
    predicted_makespan,
    tune,
)
from repro_torch.mpc.engine import (
    WAVE_SCALARS,
    MPCEngine,
    request_scalars,
    wave_width,
)
from repro_torch.mpc.field import generator
from repro_torch.mpc.workers import (
    EDGE_SERVER,
    GATEWAY,
    PHONE,
    WorkerPool,
    dispatch_waves,
    modeled_makespan,
    slot_scalars,
    slot_times,
)
from repro_torch.sim import (
    Arrival,
    ArrivalTrace,
    FleetEvent,
    FleetModel,
    PhaseRecorder,
    ReplayConfig,
    Simulator,
    calibrate,
    divergence_report,
    fit_class_multipliers,
    gate,
    predict,
    replay,
)
from repro_torch.sim.divergence import skewed_fleet_pool
from repro_torch import sim as t_sim
from repro_torch.sim import divergence as t_div
from repro_torch.mpc import autotune as t_autotune
from repro_torch.mpc import byzantine as t_byz
from repro_torch.mpc import workers as t_workers
from repro_torch.mpc.protocol import AGECMPCProtocol as TProto


def small_spec(pool, *, adversaries=0, z=2, shape=(32, 32, 32)):
    spec = tune(pool=pool, z=z, shape=shape).spec
    if adversaries:
        spec = dataclasses.replace(spec, adversaries=adversaries)
    return spec


# ========================================================== event core
class TestEventCore:
    def test_ties_fire_in_insertion_order(self):
        sim, seen = Simulator(), []
        sim.on("a", lambda s, ev: seen.append(ev.payload))
        for i in range(5):
            sim.schedule(7.0, "a", i)
        sim.schedule(3.0, "a", "first")
        assert sim.run() == 7.0
        assert seen == ["first", 0, 1, 2, 3, 4]

    def test_past_scheduling_raises(self):
        sim = Simulator()
        sim.on("tick", lambda s, ev: s.schedule(s.now - 1.0, "tick"))
        sim.schedule(5.0, "tick")
        with pytest.raises(ValueError, match="cannot schedule"):
            sim.run()

    def test_unknown_kind_and_duplicate_handler_raise(self):
        sim = Simulator()
        sim.on("a", lambda s, ev: None)
        with pytest.raises(ValueError, match="already registered"):
            sim.on("a", lambda s, ev: None)
        sim.schedule(0.0, "mystery")
        with pytest.raises(ValueError, match="no handler"):
            sim.run()

    def test_runaway_loop_guard(self):
        sim = Simulator()
        sim.on("tick", lambda s, ev: s.schedule(s.now + 1.0, "tick"))
        sim.schedule(0.0, "tick")
        with pytest.raises(RuntimeError, match="exceeded"):
            sim.run(max_events=100)


# ==================================================== trace + recorder
class TestTraceSchema:
    def test_constructors(self):
        assert [a.at_us for a in ArrivalTrace.burst(3).arrivals] == [0, 0, 0]
        u = ArrivalTrace.uniform(3, 10.0)
        assert [a.at_us for a in u.arrivals] == [0.0, 10.0, 20.0]
        p = ArrivalTrace.poisson(8, rate_rps=100.0, seed=4)
        assert p.arrivals[0].at_us == 0.0
        assert p == ArrivalTrace.poisson(8, rate_rps=100.0, seed=4)
        with pytest.raises(ValueError, match="time-sorted"):
            ArrivalTrace((Arrival(5.0, 0), Arrival(1.0, 1)))
        with pytest.raises(ValueError, match="fail|corrupt"):
            FleetEvent(0.0, 3, kind="melt")

    def test_fault_decorators(self):
        t = ArrivalTrace.burst(2).with_faults(
            FleetEvent(9.0, 1), FleetEvent(2.0, 0, kind="corrupt"))
        assert [f.at_us for f in t.faults] == [2.0, 9.0]  # sorted
        assert t.without_faults().faults == ()
        assert t.without_faults().arrivals == t.arrivals

    def test_json_round_trip(self, tmp_path):
        t = ArrivalTrace.poisson(5, rate_rps=50.0, seed=1).with_faults(
            FleetEvent(3.0, 2, kind="corrupt"))
        path = str(tmp_path / "trace.json")
        t.save(path)
        assert ArrivalTrace.load(path) == t
        with pytest.raises(ValueError, match="version"):
            ArrivalTrace.from_json({"version": 99})

    def test_recorder_round_trip(self, tmp_path):
        rec = PhaseRecorder()
        rec.record(device=3, klass="phone", phase="compute",
                   scalars=100.0, us=7.5, lanes=2)
        rec.record(device=-1, klass="age", phase="front",
                   scalars=10.0, us=1.0)
        path = str(tmp_path / "samples.json")
        rec.save(path)
        back = PhaseRecorder.load(path)
        assert back.samples == rec.samples
        grouped = back.by_class(phases=("compute",))
        assert set(grouped) == {("phone", "compute")}


# ============================================== shared formula plumbing
class TestSharedFormulas:
    def test_dispatch_waves(self):
        assert dispatch_waves(18, None) == 1
        assert dispatch_waves(18, 18) == 1
        assert dispatch_waves(18, 8) == 3
        with pytest.raises(ValueError):
            dispatch_waves(18, 0)

    def test_module_wave_width_matches_engine(self):
        from repro_torch.mpc import AGECMPCProtocol
        spec = AGECMPCProtocol(s=2, t=2, z=2, m=8).spec
        eng = MPCEngine(max_batch=16, device="cpu")
        assert (wave_width(spec, max_batch=16, wave_scalars=WAVE_SCALARS)
                == eng._wave_width(AGECMPCProtocol(s=2, t=2, z=2, m=8)))
        assert wave_width(spec, max_batch=16, inflight=4) == 4
        assert wave_width(spec, max_batch=16, inflight=3) == 2  # pow2 floor
        assert wave_width(spec, max_batch=16, wave_scalars=None) == 16
        assert request_scalars(spec) > 0

    def test_modeled_makespan_reduces_slot_times(self):
        pool = WorkerPool.of((PHONE, 20), (GATEWAY, 12))
        cm = DEFAULT_COST
        m, s, t, z, n = 24, 2, 2, 2, 12
        placement = pool.place(n, cm)
        times = slot_times(m, s, t, z, n, cm, pool, placement)
        worst = max(sum(tr) for tr in times)
        assert modeled_makespan(m, s, t, z, n, cm, pool, placement) \
            == pytest.approx(worst)
        # the wave multiplier is linear and validated
        assert modeled_makespan(m, s, t, z, n, cm, pool, placement,
                                waves=3.0) == pytest.approx(3.0 * worst)
        with pytest.raises(ValueError):
            modeled_makespan(m, s, t, z, n, cm, pool, placement, waves=0.5)

    def test_slot_scalars_price_to_slot_times(self):
        """slot_times is exactly slot_scalars × weights × device rates —
        the identity the calibration fit inverts."""
        pool = WorkerPool.of((GATEWAY, 8), (EDGE_SERVER, 8))
        cm = CostModel()
        m, s, t, z, n = 16, 2, 2, 2, 10
        placement = tuple(range(n))
        raw = slot_scalars(m, s, t, z, n, len(placement))
        times = slot_times(m, s, t, z, n, cm, pool, placement)
        weights = (cm.computation, cm.storage, cm.communication)
        axes = ("compute", "storage", "link")
        for slot, dev in enumerate(placement):
            w = pool.workers[dev]
            for pi in range(3):
                want = raw[slot][pi] * weights[pi] * getattr(w, axes[pi])
                assert times[slot][pi] == pytest.approx(want)


# ================================================= recalibration model
class TestRecalibration:
    def test_pool_recalibrated_scales_rates(self):
        pool = WorkerPool.of((PHONE, 2), (GATEWAY, 2))
        re = pool.recalibrated({"phone": (2.0, 3.0, 4.0)})
        assert len(re) == len(pool)
        for w, r in zip(pool.workers, re.workers, strict=True):
            assert r.name == w.name
            if w.name == "phone":
                assert (r.compute, r.storage, r.link) == (
                    w.compute * 2.0, w.storage * 3.0, w.link * 4.0)
            else:
                assert (r.compute, r.storage, r.link) == (
                    w.compute, w.storage, w.link)

    def test_cost_model_multipliers_round_trip_and_validate(self):
        cm = CostModel().with_class_multipliers(
            {"phone": (2.0, 1.0, 1.5), "gateway": (1.0, 1.0, 1.0)})
        assert dict(cm.class_multipliers)["phone"] == (2.0, 1.0, 1.5)
        pool = WorkerPool.of((PHONE, 2))
        re = cm.recalibrated_pool(pool)
        assert re.workers[0].compute == pool.workers[0].compute * 2.0
        assert CostModel().recalibrated_pool(pool) is pool
        with pytest.raises(ValueError):
            CostModel(class_multipliers=(("phone", (0.0, 1.0, 1.0)),))
        with pytest.raises(ValueError):
            CostModel().with_class_multipliers({"phone": (1.0, 1.0)})

    def test_multipliers_steer_placement(self):
        """Planted slowness on the nominally fast class flips which
        devices the recalibrated model places."""
        pool = WorkerPool.of((GATEWAY, 8), (EDGE_SERVER, 8))
        base = CostModel()
        drifted = base.with_class_multipliers(
            {"edge-server": (50.0, 50.0, 50.0)})
        fast_first = pool.place(4, base)
        assert all(pool[d].name == "edge-server" for d in fast_first)
        avoided = drifted.recalibrated_pool(pool).place(4, drifted)
        assert all(pool[d].name == "gateway" for d in avoided)

    def test_predicted_makespan_requires_pool(self):
        spec = tune(17, 2, (32, 32, 32)).spec
        with pytest.raises(ValueError, match="pool"):
            predicted_makespan(spec)


# ======================================================== replay core
class TestReplay:
    def setup_method(self):
        self.pool = WorkerPool.of((PHONE, 40), (GATEWAY, 20))
        self.spec = small_spec(self.pool)

    def test_deterministic_under_fixed_seed(self):
        trace = ArrivalTrace.poisson(12, rate_rps=200.0, seed=2)
        reports = [
            replay(self.spec, trace,
                   fleet=FleetModel(self.pool, jitter=0.1, seed=11))
            for _ in range(2)]
        assert reports[0].makespan_us == reports[1].makespan_us
        assert reports[0].completions == reports[1].completions
        assert reports[0].samples == reports[1].samples
        other = replay(self.spec, trace,
                       fleet=FleetModel(self.pool, jitter=0.1, seed=12))
        assert other.makespan_us != reports[0].makespan_us

    def test_predicted_equals_replayed_at_zero_noise(self):
        trace = ArrivalTrace.burst(9)
        rep = replay(self.spec, trace, fleet=FleetModel(self.pool))
        pred = predict(self.spec, trace)
        assert rep.makespan_us == pred.makespan_us
        assert rep.waves == pred.waves
        assert rep.served == len(trace)

    def test_single_burst_wave_matches_modeled_makespan(self):
        """One saturated wave's duration IS the cost model's formula —
        the shared-formula guarantee, end to end."""
        sp = self.spec
        rep = replay(sp, ArrivalTrace.burst(1), fleet=FleetModel(self.pool))
        placement = sp.effective_placement
        want = modeled_makespan(
            sp.m, sp.s, sp.t, sp.z, sp.n_workers, DEFAULT_COST,
            self.pool, placement) + DEFAULT_COST.dispatch
        assert rep.makespan_us == pytest.approx(want)

    def test_sharded_axis_serializes_dispatch(self):
        cfg = ReplayConfig(axis_size=4)
        one = replay(self.spec, ArrivalTrace.burst(1),
                     fleet=FleetModel(self.pool))
        sh = replay(self.spec, ArrivalTrace.burst(1),
                    fleet=FleetModel(self.pool), config=cfg)
        waves = dispatch_waves(self.spec.n_workers, 4)
        assert waves > 1
        assert sh.makespan_us == pytest.approx(one.makespan_us * waves)

    def test_blocks_consume_multiple_waves(self):
        t1 = ArrivalTrace.burst(1)
        t3 = ArrivalTrace(tuple([Arrival(0.0, 0, blocks=3)]))
        r1 = replay(self.spec, t1, fleet=FleetModel(self.pool))
        r3 = replay(self.spec, t3, fleet=FleetModel(self.pool))
        assert r3.served == 1
        assert r3.makespan_us == pytest.approx(3 * r1.makespan_us)

    def test_requires_pool_and_matching_roster(self):
        no_pool = tune(17, 2, (32, 32, 32)).spec
        with pytest.raises(ValueError, match="WorkerPool"):
            replay(no_pool, ArrivalTrace.burst(1))
        with pytest.raises(ValueError, match="roster"):
            replay(self.spec, ArrivalTrace.burst(1),
                   fleet=FleetModel(WorkerPool.of((PHONE, 3))))

    def test_tuned_beats_oblivious_on_skewed_pool(self):
        pool = skewed_fleet_pool(200)
        spec = small_spec(pool)
        oblivious = dataclasses.replace(
            spec, placement=tuple(range(spec.n_workers)))
        trace = ArrivalTrace.burst(8)
        tuned_us = replay(spec, trace,
                          fleet=FleetModel(pool, jitter=0.02, seed=0)
                          ).makespan_us
        obl_us = replay(oblivious, trace,
                        fleet=FleetModel(pool, jitter=0.02, seed=0)
                        ).makespan_us
        assert tuned_us < obl_us


# ============================================ attrition + Byzantine
class TestFaults:
    def setup_method(self):
        self.pool = WorkerPool.of((PHONE, 40), (GATEWAY, 20))
        self.spec = small_spec(self.pool)
        self.quorum = self.spec.t ** 2 + self.spec.z

    def test_dropout_within_quorum_is_free(self):
        """Losing a placed device while staying at quorum is phase-3
        dropout: no replan, makespan can only shrink (one slot fewer in
        the worst-slot max)."""
        victim = int(self.spec.placement[0])
        trace = ArrivalTrace.burst(4).with_faults(
            FleetEvent(0.0, victim, kind="fail"))
        clean = replay(self.spec, ArrivalTrace.burst(4),
                       fleet=FleetModel(self.pool))
        rep = replay(self.spec, trace, fleet=FleetModel(self.pool))
        assert rep.served == 4 and rep.replans == 0
        assert rep.makespan_us <= clean.makespan_us
        assert victim not in {s.device for s in rep.samples}

    def test_attrition_below_quorum_triggers_replan(self):
        placed = list(self.spec.placement)
        kill = placed[: len(placed) - self.quorum + 1]
        trace = ArrivalTrace.burst(4).with_faults(
            *[FleetEvent(0.0, int(d)) for d in kill])
        rep = replay(self.spec, trace, fleet=FleetModel(self.pool))
        assert rep.served == 4
        assert rep.replans == 1
        assert not rep.failed

    def test_fleet_collapse_fails_isolated(self):
        """Below quorum with no healthy re-placement: requests fail with
        a reason, never hang or complete silently."""
        trace = ArrivalTrace.burst(3).with_faults(
            *[FleetEvent(0.0, d) for d in range(len(self.pool) - 2)])
        rep = replay(self.spec, trace, fleet=FleetModel(self.pool))
        assert rep.served == 0
        assert set(rep.failed) == {0, 1, 2}
        assert all("quorum" in reason for reason in rep.failed.values())

    def test_liar_with_budget_corrected_and_evicted(self):
        spec = small_spec(self.pool, adversaries=1)
        liar = int(spec.placement[0])
        trace = ArrivalTrace.burst(6).with_faults(
            FleetEvent(0.0, liar, kind="corrupt"))
        rep = replay(spec, trace, fleet=FleetModel(self.pool))
        assert rep.served == 6
        assert rep.corrections >= 1
        assert rep.evictions == 1
        assert rep.undetected_corruptions == 0

    def test_liars_past_budget_fail_the_wave(self):
        spec = small_spec(self.pool, adversaries=1)
        liars = [int(d) for d in spec.placement[:2]]
        trace = ArrivalTrace.burst(2).with_faults(
            *[FleetEvent(0.0, d, kind="corrupt") for d in liars])
        rep = replay(spec, trace, fleet=FleetModel(self.pool))
        assert rep.served == 0
        assert all("budget" in r for r in rep.failed.values())

    def test_liar_without_budget_corrupts_silently(self):
        liar = int(self.spec.placement[0])
        trace = ArrivalTrace.burst(5).with_faults(
            FleetEvent(0.0, liar, kind="corrupt"))
        rep = replay(self.spec, trace, fleet=FleetModel(self.pool))
        assert rep.served == 5            # nothing noticed...
        assert rep.undetected_corruptions > 0   # ...but the report knows
        assert rep.evictions == 0


# ===================================================== calibration loop
class TestCalibration:
    def test_recovers_planted_multipliers(self):
        pool = WorkerPool.of((PHONE, 30), (GATEWAY, 10))
        spec = small_spec(pool)
        # a placement straddling BOTH classes, so each gets samples
        # (roster: phones at 0..29, gateways at 30..39)
        half = spec.n_workers // 2
        mixed = tuple(range(half)) + tuple(
            range(30, 30 + spec.n_workers - half))
        both = dataclasses.replace(spec, placement=mixed)
        planted = {"phone": (1.7, 1.3, 2.1), "gateway": (0.8, 1.0, 1.2)}
        fleet = FleetModel(pool, class_multipliers=planted,
                           jitter=0.05, seed=9)
        rep = replay(both, ArrivalTrace.burst(24), fleet=fleet)
        cal = calibrate(rep.samples, pool)
        for name, want in planted.items():
            got = cal.multipliers[name]
            assert got == pytest.approx(want, rel=0.15), name
        # and the recalibrated model prices the measured fleet
        before = predicted_makespan(both)
        after = predicted_makespan(both, cost=cal.cost)
        truth = modeled_makespan(
            both.m, both.s, both.t, both.z, both.n_workers,
            DEFAULT_COST, fleet.true_pool, both.effective_placement)
        assert abs(after - truth) < abs(before - truth)

    def test_zero_jitter_recovery_is_exact(self):
        pool = WorkerPool.of((PHONE, 20), (GATEWAY, 8))
        spec = small_spec(pool)
        both = dataclasses.replace(
            spec, placement=tuple(range(spec.n_workers)))
        planted = {"phone": (2.0, 1.5, 3.0)}
        fleet = FleetModel(pool, class_multipliers=planted)
        rep = replay(both, ArrivalTrace.burst(4), fleet=fleet)
        got = fit_class_multipliers(rep.samples, pool)
        assert got["phone"] == pytest.approx((2.0, 1.5, 3.0), rel=1e-9)
        # identity placement never touched a gateway: no evidence, so
        # the class is absent (recalibrated() leaves it untouched)
        assert "gateway" not in got

    def test_thin_evidence_keeps_unit_multiplier(self):
        pool = WorkerPool.of((PHONE, 4))
        rec = PhaseRecorder()
        for i in range(2):   # below min_samples=3
            rec.record(device=0, klass="phone", phase="compute",
                       scalars=100.0, us=5000.0)
        got = fit_class_multipliers(rec.samples, pool)
        assert got.get("phone", (1.0, 1.0, 1.0))[0] == 1.0

    def test_skips_aggregate_and_mismatched_samples(self):
        pool = WorkerPool.of((PHONE, 4))
        rec = PhaseRecorder()
        rec.record(device=-1, klass="age", phase="front",
                   scalars=100.0, us=1.0)           # engine aggregate
        rec.record(device=99, klass="phone", phase="compute",
                   scalars=100.0, us=1.0)           # out of roster
        rec.record(device=0, klass="gateway", phase="compute",
                   scalars=100.0, us=1.0)           # stale class label
        assert fit_class_multipliers(rec.samples, pool) == {}


# ============================================== live recorder hooks
class TestLiveRecorderHooks:
    def test_engine_records_aggregate_samples(self):
        rec = PhaseRecorder()
        eng = MPCEngine(max_batch=8, recorder=rec, device="cpu")
        rng = np.random.default_rng(0)
        prm = dict(s=2, t=2, z=2, m=8)
        p = 2 ** 31 - 1
        for i in range(3):
            eng.submit(rng.integers(0, p, (8, 8)),
                       rng.integers(0, p, (8, 8)),
                       key=i, **prm)
        eng.flush()
        assert len(rec) > 0
        assert {s.device for s in rec.samples} == {-1}
        assert all(s.us >= 0 and s.scalars > 0 for s in rec.samples)
        phases = {s.phase for s in rec.samples}
        assert phases <= {"front", "decode", "fused"}

    def test_stages_timed_wrapper_records_each_stage(self):
        from repro_torch.mpc import AGECMPCProtocol

        proto = AGECMPCProtocol(s=2, t=2, z=2, m=8)
        rec = PhaseRecorder()
        stages = proto.plan.stages("cpu").timed(rec, plan=proto.plan)
        p = proto.field.p
        rng = np.random.default_rng(1)
        a = rng.integers(0, p, (8, 8))
        b = rng.integers(0, p, (8, 8))
        a, b = torch.from_numpy(a), torch.from_numpy(b)
        i_pts = stages.front(a, b, generator(0, "cpu"))
        assert i_pts is not None
        y = stages.fused(a, b, generator(0, "cpu"))
        a, b = a.numpy(), b.numpy()
        want = np.array((a.astype(object).T @ b.astype(object)) % p,
                        dtype=np.int64)
        np.testing.assert_array_equal(np.asarray(y), want)
        assert {s.phase for s in rec.samples} == {"front", "fused"}
        assert all(s.device == -1 and s.us >= 0 for s in rec.samples)
        assert all(s.scalars > 0 for s in rec.samples)  # plan given


# ====================================================== divergence gate
class TestDivergence:
    def test_report_math(self):
        def fake(us):
            from repro_torch.sim.replay import ReplayReport
            return ReplayReport(
                makespan_us=us, completions={}, failed={}, waves=1,
                replans=0, corrections=0, evictions=0,
                undetected_corruptions=0, device_busy_us={}, samples=())

        rep = divergence_report(
            [("a", fake(100.0), fake(110.0)),
             ("b", fake(200.0), fake(170.0))], tolerance=0.25)
        assert rep.entries[0].ratio == pytest.approx(1.1)
        assert rep.entries[0].within(0.25)
        assert rep.ranking_agrees       # a < b both predicted and replayed
        assert rep.ok
        bad = divergence_report(
            [("a", fake(100.0), fake(300.0))], tolerance=0.25)
        assert not bad.ok

    def test_ranking_flip_fails_gate(self):
        def fake(us):
            from repro_torch.sim.replay import ReplayReport
            return ReplayReport(
                makespan_us=us, completions={}, failed={}, waves=1,
                replans=0, corrections=0, evictions=0,
                undetected_corruptions=0, device_busy_us={}, samples=())

        rep = divergence_report(
            [("tuned", fake(100.0), fake(120.0)),
             ("oblivious", fake(110.0), fake(95.0))], tolerance=0.5)
        assert not rep.ranking_agrees
        assert not rep.ok

    def test_gate_green_at_fleet_scale(self):
        report = gate(devices=1000, requests=8, seed=0)
        assert report.ok, report.describe()
        assert len(report.entries) == 2
        labels = [e.label for e in report.entries]
        assert labels == ["tuned", "oblivious"]
        # the tuned spec beats the oblivious twin in BOTH worlds
        t, o = report.entries
        assert t.replayed_us < o.replayed_us
        assert t.predicted_us < o.predicted_us

    def test_gate_deterministic(self):
        a = gate(devices=300, requests=4, seed=3)
        b = gate(devices=300, requests=4, seed=3)
        assert a.describe() == b.describe()

    def test_describe_is_json(self):
        report = gate(devices=300, requests=4, seed=0)
        json.dumps(report.describe())


# ================================================ the port against JAX

def _pkg(name):
    return {"jax": (j_autotune, j_workers, j_sim, j_div),
            "torch": (t_autotune, t_workers, t_sim, t_div)}[name]


def _scenario(name, which):
    """One of ``test_sim.py``'s replay set-ups in package ``which``:
    ``(spec, trace, fleet, config)``; jitter 0 throughout."""
    at, wk, sim, div = _pkg(which)
    pool = wk.WorkerPool.of((wk.PHONE, 40), (wk.GATEWAY, 20))
    spec = at.tune(pool=pool, z=2, shape=(32, 32, 32)).spec
    byz = dataclasses.replace(spec, adversaries=1)
    quorum = spec.t ** 2 + spec.z
    placed = [int(d) for d in spec.placement]
    tr = sim.ArrivalTrace
    ev = sim.FleetEvent
    fleet = sim.FleetModel(pool)
    cfg = None
    if name == "burst9":
        trace = tr.burst(9)
    elif name == "poisson12":
        trace = tr.poisson(12, rate_rps=200.0, seed=2)
    elif name == "blocks3":
        trace = tr(tuple([sim.Arrival(0.0, 0, blocks=3)]))
    elif name == "axis4":
        trace, cfg = tr.burst(1), sim.ReplayConfig(axis_size=4)
    elif name == "dropout":
        trace = tr.burst(4).with_faults(ev(0.0, placed[0], kind="fail"))
    elif name == "below_quorum":
        trace = tr.burst(4).with_faults(
            *[ev(0.0, d) for d in placed[: len(placed) - quorum + 1]])
    elif name == "collapse":
        trace = tr.burst(3).with_faults(
            *[ev(0.0, d) for d in range(len(pool) - 2)])
    elif name == "liar_budget":
        spec, trace = byz, tr.burst(6).with_faults(
            ev(0.0, int(byz.placement[0]), kind="corrupt"))
    elif name == "liars_past_budget":
        spec, trace = byz, tr.burst(2).with_faults(
            *[ev(0.0, int(d), kind="corrupt") for d in byz.placement[:2]])
    elif name == "liar_no_budget":
        trace = tr.burst(5).with_faults(ev(0.0, placed[0], kind="corrupt"))
    elif name == "skewed":
        pool = div.skewed_fleet_pool(200)
        spec = at.tune(pool=pool, z=2, shape=(32, 32, 32)).spec
        spec = dataclasses.replace(
            spec, placement=tuple(range(spec.n_workers)))
        trace, fleet = tr.burst(8), sim.FleetModel(pool)
    else:
        raise KeyError(name)
    return spec, trace, fleet, cfg


SCENARIOS = ["burst9", "poisson12", "blocks3", "axis4", "dropout",
             "below_quorum", "collapse", "liar_budget", "liars_past_budget",
             "liar_no_budget", "skewed"]


def _samples(samples):
    return [dataclasses.astuple(s) for s in samples]


@pytest.mark.parametrize("name", SCENARIOS)
def test_predict_and_replay_equal_jax(name):
    got = {}
    for which in ("jax", "torch"):
        spec, trace, fleet, cfg = _scenario(name, which)
        sim = _pkg(which)[2]
        kw = {} if cfg is None else {"config": cfg}
        rep = sim.replay(spec, trace, fleet=fleet, **kw)
        pred = sim.predict(spec, trace, **kw)
        got[which] = (rep.describe(), pred.describe(), _samples(rep.samples),
                      rep.completions, rep.failed)
    assert got["torch"] == got["jax"]


def test_calibrated_multipliers_equal_jax():
    pool = j_workers.WorkerPool.of((j_workers.PHONE, 30),
                                   (j_workers.GATEWAY, 10))
    spec = j_autotune.tune(pool=pool, z=2, shape=(32, 32, 32)).spec
    half = spec.n_workers // 2
    mixed = dataclasses.replace(spec, placement=tuple(range(half)) + tuple(
        range(30, 30 + spec.n_workers - half)))
    planted = {"phone": (1.7, 1.3, 2.1), "gateway": (0.8, 1.0, 1.2)}
    rep = j_sim.replay(mixed, j_sim.ArrivalTrace.burst(24),
                       fleet=j_sim.FleetModel(pool, class_multipliers=planted,
                                              jitter=0.05, seed=9))
    t_samples = [t_sim.PhaseSample(*dataclasses.astuple(s))
                 for s in rep.samples]
    t_pool = t_workers.WorkerPool.of((t_workers.PHONE, 30),
                                     (t_workers.GATEWAY, 10))
    assert (t_sim.fit_class_multipliers(t_samples, t_pool)
            == j_sim.fit_class_multipliers(rep.samples, pool))
    j_cal = j_sim.calibrate(rep.samples, pool)
    t_cal = t_sim.calibrate(t_samples, t_pool)
    assert t_cal.describe() == j_cal.describe()
    assert t_cal.multipliers == j_cal.multipliers
    assert (t_cal.cost.class_multipliers == j_cal.cost.class_multipliers)


@pytest.mark.parametrize("kw", [dict(devices=300, requests=4, seed=3),
                                dict(devices=1000, requests=8, seed=0)])
def test_divergence_gate_equal_jax(kw):
    assert t_div.gate(**kw).describe() == j_div.gate(**kw).describe()


@pytest.mark.parametrize("doc", [
    {"schedule": {2: [(4, "tamper")], 0: [(1, "tag")]}},
    {"schedule": {0: [(1, "tamper")], 3: [(0, "flip"), (2, "stale")]},
     "seed": 5, "rate": 0.5, "slots": (0, 2), "mode": "flip"},
    {"seed": 1, "rate": 1.0},
])
def test_to_fleet_events_equal_jax(doc):
    j_inj = j_byz.FaultInjector(**doc)
    t_inj = t_byz.FaultInjector.from_json(j_inj.to_json())
    for round_us in (1.0, 50.0, 100.0):
        got = t_inj.to_fleet_events(round_us=round_us)
        want = j_inj.to_fleet_events(round_us=round_us)
        assert all(isinstance(e, t_sim.FleetEvent) for e in got)
        assert ([dataclasses.astuple(e) for e in got]
                == [dataclasses.astuple(e) for e in want])


@pytest.mark.parametrize("with_plan", [True, False])
def test_timed_records_equal_jax(with_plan):
    """The same calls through both packages' timed stages record the same
    ``(device, klass, phase, scalars, lanes)`` rows, and the stages' results
    are unchanged by the wrapper."""
    rng = np.random.default_rng(7)
    jp, tp = JProto(s=2, t=2, z=2, m=8), TProto(s=2, t=2, z=2, m=8)
    p = tp.field.p
    a, b = rng.integers(0, p, (8, 8)), rng.integers(0, p, (8, 8))
    recs = {}
    for which, proto in (("jax", jp), ("torch", tp)):
        rec = (j_trace if which == "jax" else t_sim.trace).PhaseRecorder()
        plan = proto.plan if with_plan else None
        if which == "jax":
            st = proto.plan.stages().timed(rec, plan=plan)
            key = jax.random.PRNGKey(0)
            k1, k2 = jax.random.split(key)
            aa, bb = jnp.asarray(a), jnp.asarray(b)
            f_a, f_b = st.encode(aa, bb, k1)
            h = st.worker_compute(f_a, f_b)
            i_pts = st.exchange(h, k2)
            idx, rows = proto.plan.survivor_tables(tuple(range(6)))
            y = st.decode(i_pts, idx, rows)
            st.front(aa, bb, key)
            y2 = st.fused(aa, bb, key)
        else:
            st = proto.plan.stages("cpu").timed(rec, plan=plan)
            aa, bb = torch.from_numpy(a), torch.from_numpy(b)
            gen = generator(0, "cpu")
            f_a, f_b = st.encode(aa, bb, gen)
            h = st.worker_compute(f_a, f_b)
            i_pts = st.exchange(h, gen)
            idx, rows = proto.plan.survivor_tables(tuple(range(6)), "cpu")
            y = st.decode(i_pts, idx, rows)
            st.front(aa, bb, generator(1, "cpu"))
            y2 = st.fused(aa, bb, generator(2, "cpu"))
        want = np.array((a.astype(object).T @ b.astype(object)) % p, np.int64)
        np.testing.assert_array_equal(np.asarray(y), want)
        np.testing.assert_array_equal(np.asarray(y2), want)
        recs[which] = [(s.device, s.klass, s.phase, s.scalars, s.lanes)
                       for s in rec.samples]
        assert all(s.us >= 0 for s in rec.samples)
    assert recs["torch"] == recs["jax"]
    assert [r[2] for r in recs["torch"]] == [
        "encode", "worker_compute", "exchange", "decode", "front", "fused"]
