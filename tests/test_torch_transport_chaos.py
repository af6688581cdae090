"""Failure paths of the port's remote backend, held against JAX's: the
kill-mid-flush cases of ``tests/test_transport.py`` (phase-2 death
replans, phase-3 death absorbed, timeout evicts, retry resends) on both
packages with the same chaos script, each exact, with the same backend
``stats``; and ``TestFaultScheduleFile``: one schedule file read by both
packages' ``FaultInjector``, driving transport chaos and the fleet-sim
replay view."""
import numpy as np
import pytest

from repro.mpc import MPCSpec as JSpec
from repro.mpc import connect as jconnect
from repro.mpc.byzantine import FaultInjector as JInjector
from repro.mpc.protocol import AGECMPCProtocol as JProto
from repro_torch.mpc import MPCSpec, connect
from repro_torch.mpc.byzantine import FaultInjector
from repro_torch.mpc.protocol import AGECMPCProtocol


def exact_matmul(a, b, p):
    return np.array((a.astype(object) @ b.astype(object)) % p, np.int64)


def both_remote(chaos, seed, **opts):
    """One block (m = 6) through each package's remote backend after the
    same chaos script; returns ``{package: (y, stats)}``."""
    spec = MPCSpec(s=2, t=2, z=1)
    rng = np.random.default_rng(seed)
    a = rng.integers(0, spec.field.p, (6, 6))
    b = rng.integers(0, spec.field.p, (6, 6))
    out = {}
    for which in ("torch", "jax"):
        if which == "torch":
            rem = connect(spec, backend="remote", device="cpu", **opts)
            proto = AGECMPCProtocol.from_spec(spec, m=6)
        else:
            rem = jconnect(JSpec(s=2, t=2, z=1), backend="remote", **opts)
            proto = JProto.from_spec(JSpec(s=2, t=2, z=1), m=6)
        try:
            for slot, doc in chaos:
                rem.backend.chaos(proto, slot, **doc)
            y = np.asarray(rem.matmul(a, b, encoded=True, m=6))
        finally:
            rem.backend.close()
        np.testing.assert_array_equal(y, exact_matmul(a, b, spec.field.p))
        out[which] = (y, dict(rem.backend.stats))
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    return out


# ====================================================== failure recovery
class TestKillMidFlush:
    """Chaos-scripted deaths mid-flush degrade into the elastic path."""

    def test_phase2_death_replans_and_recovers(self):
        """A worker dying BEFORE its G row lands is a phase-2 loss: the
        backend fails the device, replans and re-dispatches, exactly."""
        out = both_remote([(1, dict(die_block=0, die_after="shares"))], 21)
        st = out["torch"][1]
        assert st["phase_losses"] >= 1 and st["redispatches"] >= 1
        assert st == out["jax"][1]

    def test_phase3_death_absorbed_by_mask(self):
        """A worker dying AFTER its G row is a phase-3 loss: only its own
        I-point echo is missing, and any t²+z survivors decode."""
        out = both_remote([(2, dict(die_block=0, die_after="ipoint"))], 22)
        st = out["torch"][1]
        assert st["phase3_absorbed"] >= 1 and st["phase_losses"] == 0
        assert st == out["jax"][1]

    def test_timeout_evicts_and_replans_deterministically(self):
        """A stalled socket must not hang the flush: the deadline fires,
        the worker is evicted and the block re-dispatches through the
        replan path, with an equal result on a re-run."""
        chaos = [(0, dict(stall_block=0, stall_s=30.0))]
        runs = [both_remote(chaos, 23, deadline_s=0.5, retries=0)
                for _ in range(2)]
        np.testing.assert_array_equal(runs[0]["torch"][0],
                                      runs[1]["torch"][0])
        for out in runs:
            st = out["torch"][1]
            assert st["evictions"] >= 1 and st["phase_losses"] >= 1
            assert st == out["jax"][1]

    def test_retry_resends_before_evicting(self):
        """A short stall inside the retry budget is absorbed by a resend
        (idempotent worker replies), with no eviction.  The number of
        resends depends on timing; every other counter equals JAX's."""
        out = both_remote([(0, dict(stall_block=0, stall_s=0.8))], 24,
                          deadline_s=0.4, retries=2)
        st, jst = out["torch"][1], out["jax"][1]
        assert st["retries"] >= 1 and jst["retries"] >= 1
        assert st["evictions"] == 0
        assert ({k: v for k, v in st.items() if k != "retries"}
                == {k: v for k, v in jst.items() if k != "retries"})


# ============================================== shared fault schedules
class TestFaultScheduleFile:
    """One JSON schedule file, two consumers (the transport chaos hooks
    and the fleet simulator's FleetEvent replay), read by both packages."""

    def test_injector_json_round_trip(self, tmp_path):
        inj = FaultInjector(seed=5,
                            schedule={0: [(1, "tamper")],
                                      3: [(0, "flip"), (2, "stale")]},
                            rate=0.5, slots=(0, 2), mode="flip")
        path = tmp_path / "faults.json"
        inj.save(str(path))
        back = FaultInjector.load(str(path))
        assert back.to_json() == inj.to_json()
        assert back.schedule == {0: [(1, "tamper")],
                                 3: [(0, "flip"), (2, "stale")]}
        assert back.seed == 5 and back.rate == 0.5
        assert back.slots == (0, 2) and back.mode == "flip"
        # runtime state (the corruption log) is not configuration
        assert back.log == []
        # the reference reads the port's file, and the other way round
        assert JInjector.load(str(path)).to_json() == inj.to_json()
        JInjector.from_json(inj.to_json()).save(str(path))
        assert FaultInjector.load(str(path)).to_json() == inj.to_json()

    def test_unsupported_version_rejected(self):
        with pytest.raises(ValueError, match="version"):
            FaultInjector.from_json({"version": 99, "schedule": []})

    def test_empty_schedule_normalizes_to_none(self):
        back = FaultInjector.from_json(FaultInjector(seed=1).to_json())
        assert back.schedule is None

    def test_to_fleet_events_projection(self):
        inj = FaultInjector(schedule={2: [(4, "tamper")], 0: [(1, "tag")]})
        ev = inj.to_fleet_events(round_us=100.0)
        assert [(e.at_us, e.device, e.kind) for e in ev] == [
            (0.0, 1, "corrupt"), (200.0, 4, "corrupt")]

    def test_one_file_drives_transport_chaos_and_replay(self, tmp_path):
        """The same saved schedule kills transport workers (as erasure
        chaos) in both packages AND projects onto fleet-sim corruption
        events, equal in both."""
        JInjector(schedule={0: [(1, "tamper")]}).save(str(tmp_path / "s.json"))
        shared = FaultInjector.load(str(tmp_path / "s.json"))
        events = shared.to_fleet_events(round_us=50.0)
        assert [(e.device, e.kind) for e in events] == [(1, "corrupt")]
        assert [(e.at_us, e.device, e.kind) for e in events] == [
            (e.at_us, e.device, e.kind) for e in JInjector.load(
                str(tmp_path / "s.json")).to_fleet_events(round_us=50.0)]
        assert shared.schedule is not None
        # a liar the wire cannot verify is evicted, i.e. killed at the
        # scripted (round → block) point
        chaos = [(slot, dict(die_block=rnd, die_after="shares"))
                 for rnd, entries in shared.schedule.items()
                 for slot, _mode in entries]
        out = both_remote(chaos, 31)
        assert out["torch"][1]["phase_losses"] >= 1
        assert out["torch"][1] == out["jax"][1]
