"""The port's batched engine held against the JAX package's.

The scenarios of ``tests/test_elastic_engine.py`` and
``tests/test_wave_admission.py`` run through both engines, step for step:
mixed dropout, attrition, retune and replan escalation, the tamper
schedule, budget exhaustion, infeasible pools, exact-tail waves,
round-robin order and deferral.  After every flush the two must agree on
``Y`` (integer-equal), ``stats``, the ``failures`` keys and the liars
drained.  A request's I-points must not depend on the wave it lands in
(width 1 against width 8)."""
import jax
import numpy as np
import pytest
import torch

from repro.mpc import FaultInjector as JInjector
from repro.mpc import MPCSpec as JSpec
from repro.mpc import connect as jconnect
from repro.mpc.engine import MPCEngine as JEngine
from repro_torch.mpc import AGECMPCProtocol, FaultInjector, MPCSpec, connect
from repro_torch.mpc.engine import MPCEngine, _next_wave, wave_width
from repro_torch.mpc.engine import WAVE_SCALARS, request_scalars

SMALL = dict(s=2, t=2, z=2, m=8)
OTHER = dict(s=3, t=2, z=2, m=12)


def exact_ref(a, b, p):
    return np.array((a.astype(object).T @ b.astype(object)) % p, np.int64)


def random_mask(rng, n, t2z):
    mask = np.zeros(n, bool)
    mask[rng.choice(n, int(rng.integers(t2z, n)), replace=False)] = True
    return mask


class Both:
    """One scenario on both engines: every call goes to each, and every
    flush is compared."""

    def __init__(self, injector=None, **kw):
        self.j = JEngine(injector=None if injector is None
                         else JInjector(**injector), **kw)
        self.t = MPCEngine(injector=None if injector is None
                           else FaultInjector(**injector), device="cpu", **kw)
        self.want = {}

    @staticmethod
    def _kw(eng, prm):
        if "spec" not in prm:
            return prm
        cls = JSpec if isinstance(eng, JEngine) else MPCSpec
        return {"spec": cls(**prm["spec"])}

    def fail(self, workers, prm):
        for eng in (self.j, self.t):
            eng.fail(workers, **self._kw(eng, prm))

    def submit(self, a, b, key, prm, survivors=None, p=None):
        rj = self.j.submit(a, b, key=jax.random.PRNGKey(key),
                           survivors=survivors, **self._kw(self.j, prm))
        rt = self.t.submit(a, b, key=key, survivors=survivors,
                           **self._kw(self.t, prm))
        assert rj == rt
        if p is not None:
            self.want[rt] = exact_ref(a, b, p)
        return rt

    def flush(self):
        jr, tr = self.j.flush(), self.t.flush()
        assert sorted(tr) == sorted(jr)
        for rid in tr:
            np.testing.assert_array_equal(tr[rid].numpy(),
                                          np.asarray(jr[rid]))
            if rid in self.want:
                np.testing.assert_array_equal(tr[rid].numpy(),
                                              self.want[rid])
        assert self.t.stats == self.j.stats
        assert sorted(self.t.failures) == sorted(self.j.failures)
        assert self.t.take_new_liars() == self.j.take_new_liars()
        assert self.t.pending() == self.j.pending() == 0
        return tr


def _ops(rng, prm, n):
    proto = AGECMPCProtocol(**prm)
    p, m = proto.field.p, prm["m"]
    return proto, [(rng.integers(0, p, (m, m)), rng.integers(0, p, (m, m)))
                   for _ in range(n)]


# ------------------------------------------- test_elastic_engine.py
def test_mixed_dropout_batch_equals_jax():
    both = Both(max_batch=16)
    rng = np.random.default_rng(0)
    for i in range(16):
        prm = (SMALL, OTHER)[i % 2]
        proto, [(a, b)] = _ops(rng, prm, 1)
        surv = (random_mask(rng, proto.n_workers, proto.recovery_threshold)
                if i % 3 else None)
        both.submit(a, b, i, prm, survivors=surv, p=proto.field.p)
    both.flush()
    assert both.t.stats["batches"] == 2
    plan = AGECMPCProtocol(**SMALL).plan
    assert ("vfront", "cpu") in plan._runners
    assert ("vdecode", "cpu") in plan._runners


def test_waves_across_flushes_equal_jax():
    both = Both(max_batch=8)
    rng = np.random.default_rng(1)
    for flush in range(3):
        proto, ops = _ops(rng, SMALL, 4 - flush)
        for i, (a, b) in enumerate(ops):
            both.submit(a, b, flush * 10 + i, SMALL, p=proto.field.p)
        both.flush()


@pytest.mark.parametrize("spares,dead", [(2, [2, 5]), (1, list(range(10))),
                                         (0, [0])])
def test_attrition_and_escalation_equal_jax(spares, dead):
    both = Both(spares=spares, max_batch=8)
    rng = np.random.default_rng(5)
    proto, ops = _ops(rng, SMALL, 3)
    both.fail(dead, SMALL)
    mask = np.ones(proto.n_workers, bool)
    mask[0] = False
    both.submit(*ops[0], 1, SMALL, survivors=mask, p=proto.field.p)
    both.submit(*ops[1], 2, SMALL, p=proto.field.p)
    both.flush()
    both.submit(*ops[2], 3, SMALL, p=proto.field.p)
    both.flush()


def test_infeasible_pool_and_under_threshold_fail_alone_like_jax():
    both = Both(spares=0, max_batch=4)
    rng = np.random.default_rng(7)
    tiny = dict(s=1, t=2, z=1, m=4)
    proto = AGECMPCProtocol(**tiny)
    both.fail(list(range(proto.n_workers)), tiny)
    z4 = np.zeros((4, 4), np.int64)
    both.submit(z4, z4, 0, tiny)
    sp, [(a, b)] = _ops(rng, SMALL, 1)
    both.submit(a, b, 1, SMALL, p=sp.field.p)
    both.flush()
    assert "infeasible" in both.t.failures[0]
    both = Both(spares=2, max_batch=4)        # the pool stays at N
    both.fail([0], SMALL)
    doomed = np.zeros(sp.n_workers, bool)
    doomed[: sp.recovery_threshold] = True
    both.submit(a, b, 2, SMALL, survivors=doomed)
    both.submit(a, b, 3, SMALL, p=sp.field.p)
    both.flush()
    assert "threshold" in both.t.failures[0]


def test_retune_escalation_equal_jax_and_to_the_fixed_spec():
    both = Both(spares=1, max_batch=8)
    rng = np.random.default_rng(3)
    proto, [(a, b)] = _ops(rng, SMALL, 1)
    both.fail(list(range(proto.n_workers - 7)), SMALL)
    rid = both.submit(a, b, 11, SMALL, p=proto.field.p)
    y = both.flush()[rid]
    assert both.t.stats["retunes"] == 1
    served = both.t._replans[proto.plan_key]
    assert served.spec.plan_key() == \
        both.j._replans[proto.plan_key].spec.plan_key()
    np.testing.assert_array_equal(
        y.numpy(), served.run(a, b, 11, device="cpu").numpy())


# -------------------------------------------------- byzantine serving
VERIFIED = {"spec": dict(s=2, t=2, z=2, m=8, adversaries=2)}


def test_verified_flush_pins_counters_like_jax():
    sched = {0: [(3, "tamper")], 1: [(3, "tamper"), (9, "tag")]}
    both = Both(injector=dict(seed=4, schedule=sched))
    rng = np.random.default_rng(12)
    proto, ops = _ops(rng, SMALL, 3)
    for i, (a, b) in enumerate(ops):
        both.submit(a, b, i, VERIFIED, p=proto.field.p)
    both.flush()
    assert both.t.stats["corrections"] == 3
    assert both.t.stats["evicted_devices"] == 2
    assert both.t.injector.log == both.j.injector.log
    plan = AGECMPCProtocol(**SMALL).plan
    assert ("vtags", "cpu") in plan._runners


def test_budget_exhaustion_and_liar_eviction_like_jax():
    one = {"spec": dict(s=2, t=2, z=2, m=8, adversaries=1)}
    both = Both(injector=dict(seed=6, schedule={1: [(2, "tamper"),
                                                    (7, "tamper")]}))
    rng = np.random.default_rng(14)
    proto, [(a, b)] = _ops(rng, SMALL, 1)
    both.submit(a, b, 0, one, p=proto.field.p)
    both.submit(a, b, 1, one)
    both.flush()
    assert "budget" in both.t.failures[1]
    both = Both(spares=1, injector=dict(seed=8, schedule={
        0: [(1, "tamper"), (5, "tamper")]}))
    both.submit(a, b, 0, VERIFIED, p=proto.field.p)
    both.flush()
    both.submit(a, b, 1, VERIFIED, p=proto.field.p)
    both.flush()
    assert both.t.stats["replans"] == 1
    key = AGECMPCProtocol.from_spec(MPCSpec(**VERIFIED["spec"])).group_key
    assert both.t._replans[key].adversaries == 2


# ------------------------------------------ test_wave_admission.py
def test_wave_helpers_equal_jax():
    from repro.mpc import engine as je

    for n in range(1, 70):
        for cap in (1, 4, 16, 64):
            assert _next_wave(n, cap) == je._next_wave(n, cap)
    assert WAVE_SCALARS == je.WAVE_SCALARS == MPCEngine.WAVE_SCALARS
    for prm in (SMALL, OTHER, dict(s=2, t=2, z=2, m=144),
                dict(s=2, t=2, z=2, m=2048)):
        t, j = MPCSpec(**prm), JSpec(**prm)
        assert request_scalars(t) == je.request_scalars(j)
        for kw in ({}, {"wave_scalars": None}, {"inflight": 2},
                   {"wave_scalars": WAVE_SCALARS}):
            assert wave_width(t, max_batch=16, **kw) == \
                je.wave_width(j, max_batch=16, **kw)


def test_exact_tails_and_padding_equal_jax():
    both = Both(max_batch=64)
    rng = np.random.default_rng(0)
    for n, key0 in ((17, 0), (15, 100), (5, 200)):
        proto, ops = _ops(rng, SMALL, n)
        for i, (a, b) in enumerate(ops):
            both.submit(a, b, key0 + i, SMALL, p=proto.field.p)
        both.flush()
    assert both.t.stats["padded_lanes"] == 1
    assert both.t.stats["waves"] == 2 + 1 + 2


def test_width1_path_and_verified_width1_equal_jax():
    both = Both(spares=2, max_batch=8, inflight=1)
    rng = np.random.default_rng(1)
    proto, ops = _ops(rng, SMALL, 4)
    for i, (a, b) in enumerate(ops[:3]):
        both.submit(a, b, i, SMALL, p=proto.field.p)
    mask = np.ones(proto.n_workers, bool)
    mask[:3] = False
    both.submit(*ops[3], 50, SMALL, survivors=mask, p=proto.field.p)
    both.submit(*ops[0], 60, {"spec": dict(SMALL, adversaries=1)},
                p=proto.field.p)
    both.flush()
    assert both.t.stats["batches"] == 1       # only the verified lane
    both.fail([0], SMALL)
    doomed = np.zeros(proto.n_workers, bool)
    doomed[: proto.recovery_threshold] = True
    both.submit(*ops[1], 51, SMALL, survivors=doomed)
    both.submit(*ops[1], 52, SMALL, p=proto.field.p)
    both.flush()


def test_round_robin_order_and_deferral_equal_jax(monkeypatch):
    orders = {}
    for name, cls in (("j", JEngine), ("t", MPCEngine)):
        orig = cls._serve_single

        def spy(self, proto, replanned, req, results, _o=orig, _n=name):
            orders.setdefault(_n, []).append((proto.spec.m, req.rid))
            return _o(self, proto, replanned, req, results)

        monkeypatch.setattr(cls, "_serve_single", spy)
    both = Both(max_batch=8, inflight=1)
    rng = np.random.default_rng(3)
    for prm, n, key0 in ((SMALL, 6, 0), (OTHER, 2, 200)):
        proto, ops = _ops(rng, prm, n)
        for i, (a, b) in enumerate(ops):
            both.submit(a, b, key0 + i, prm, p=proto.field.p)
    both.flush()
    assert orders["t"] == orders["j"]
    assert [m for m, _ in orders["t"][:4]] == [8, 12, 8, 12]
    both = Both(spares=1, max_batch=8)
    proto = AGECMPCProtocol(**SMALL)
    both.fail(list(range(proto.n_workers - 7)), SMALL)
    for prm, key0 in ((SMALL, 0), (OTHER, 300)):
        pr, ops = _ops(rng, prm, 2)
        for i, (a, b) in enumerate(ops):
            both.submit(a, b, key0 + i, prm, p=pr.field.p)
    both.flush()
    assert both.t.stats["deferred_groups"] == 1
    _, [(a, b)] = _ops(rng, SMALL, 1)
    both.submit(a, b, 400, SMALL, p=proto.field.p)
    both.flush()
    assert both.t.stats["deferred_groups"] == 1


@pytest.mark.parametrize("n_bad,n_ok,kills,inflight", [
    (1, 1, 1, None), (4, 2, 11, 1), (2, 4, 5, 2), (3, 3, 10, None)])
def test_degraded_group_never_starved_like_jax(n_bad, n_ok, kills, inflight):
    both = Both(spares=2, max_batch=8, inflight=inflight)
    rng = np.random.default_rng(n_bad * 100 + n_ok * 10 + kills)
    proto = AGECMPCProtocol(**SMALL)
    both.fail(list(range(min(kills, proto.n_workers
                             - proto.recovery_threshold))), SMALL)
    for prm, n, key0 in ((SMALL, n_bad, 0), (OTHER, n_ok, 500)):
        pr, ops = _ops(rng, prm, n)
        for i, (a, b) in enumerate(ops):
            both.submit(a, b, key0 + i, prm, p=pr.field.p)
    both.flush()
    assert not both.t.failures


# ------------------------------------------------- port-only properties
def test_a_requests_i_points_do_not_depend_on_its_wave():
    plan = AGECMPCProtocol(**SMALL).plan
    rng = np.random.default_rng(9)
    _, ops = _ops(rng, SMALL, 8)
    a = torch.from_numpy(np.stack([x for x, _ in ops]))
    b = torch.from_numpy(np.stack([y for _, y in ops]))
    keys = list(range(30, 38))
    wide = plan.batched("vfront", "cpu")(a, b, keys)
    stages = plan.stages("cpu")
    for i, key in enumerate(keys):
        one = plan.batched("vfront", "cpu")(a[i:i + 1], b[i:i + 1], [key])
        g = torch.Generator()
        g.manual_seed(key)
        single = stages.front(a[i], b[i], g)
        assert torch.equal(wide[i], one[0])
        assert torch.equal(wide[i], single)
    # the decode of a pattern's lanes: all lanes, or some by index
    idx, rows = plan.survivor_tables(tuple(range(6)), "cpu")
    vdec = plan.batched("vdecode", "cpu")
    all_y = vdec(wide, idx, rows)
    some = vdec(wide, idx, rows, torch.tensor([6, 1]))
    assert torch.equal(some[0], all_y[6]) and torch.equal(some[1], all_y[1])
    for i, (x, y) in enumerate(ops):
        np.testing.assert_array_equal(all_y[i].numpy(),
                                      exact_ref(x, y, plan.p))


def test_session_mirrors_scheduler_stats_like_jax():
    ts = connect(MPCSpec(s=2, t=2, z=2), backend="batched", max_batch=8,
                 device="cpu")
    js = jconnect(JSpec(s=2, t=2, z=2), backend="batched", max_batch=8)
    rng = np.random.default_rng(5)
    a = rng.standard_normal((12, 12))
    b = rng.standard_normal((12, 12))
    np.testing.assert_array_equal(ts.matmul(a, b).numpy(),
                                  np.asarray(js.matmul(a, b)))
    assert ts.stats == js.stats
    assert ts.stats["waves"] >= 1
