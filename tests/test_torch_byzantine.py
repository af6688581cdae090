"""The port's Byzantine decode held against the JAX package.

Berlekamp–Welch error location equal on planted errors (both primes); MAC
tags integer-equal given the same ``(γ, o, r)``; the fault injector's log
and deltas equal, and its JSON documents loading both ways; verified and
error-correcting decodes giving JAX's ``Y`` and liars under scripted
corruption, across the three schemes and both primes; the session's
eviction of liars on the local and batched backends."""
import jax
import numpy as np
import pytest
import torch

from repro.mpc import AGECMPCProtocol as JProto
from repro.mpc import FaultInjector as JInjector
from repro.mpc import MPCSpec as JSpec
from repro.mpc import byzantine as jbyz
from repro.mpc.field import Field as JField
from repro_torch.mpc import (
    AdversaryBudgetError,
    AGECMPCProtocol,
    FaultInjector,
    Field,
    MPCSpec,
    QuorumError,
    WorkerPool,
    connect,
)
from repro_torch.mpc import byzantine as byz
from repro_torch.mpc.field import P_DEFAULT, P_MERSENNE31

PRIMES = [P_DEFAULT, P_MERSENNE31]
SCHEMES = ["age", "entangled", "polydot"]


def exact_ref(a, b, p):
    return np.array((a.astype(object).T @ b.astype(object)) % p, np.int64)


def protos(scheme, p, a=2, m=4):
    kw = dict(s=2, t=2, z=2, m=m, scheme=scheme, adversaries=a)
    return (JProto.from_spec(JSpec(field=JField(p), **kw)),
            AGECMPCProtocol.from_spec(MPCSpec(field=Field(p), **kw)))


# ====================================================== Berlekamp–Welch
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n_err", [0, 1, 2, 3])
@pytest.mark.parametrize("p", PRIMES)
def test_locate_errors_equals_jax(p, n_err, seed):
    rng = np.random.default_rng(100 * seed + n_err)
    d, a = 6, 3
    coeffs = rng.integers(0, p, d)
    alphas = np.arange(1, d + 2 * a + 1, dtype=np.int64)
    values = byz._poly_eval(Field(p), coeffs, alphas)
    np.testing.assert_array_equal(
        values, jbyz._poly_eval(JField(p), coeffs, alphas))
    planted = sorted(rng.choice(len(alphas), size=n_err, replace=False))
    for pos in planted:
        values[pos] = (values[pos] + int(rng.integers(1, p))) % p
    found = byz.locate_errors(Field(p), alphas, values, d, a)
    np.testing.assert_array_equal(
        found, jbyz.locate_errors(JField(p), alphas, values, d, a))
    assert list(found) == [int(x) for x in planted]


def test_locate_errors_refusals_equal_jax():
    f, jf = Field(P_DEFAULT), JField(P_DEFAULT)
    for mod, fld in ((byz, f), (jbyz, jf)):
        with pytest.raises(Exception, match="points") as ei:
            mod.locate_errors(fld, np.arange(1, 8), np.zeros(7, np.int64),
                              degree_bound=6, max_errors=2)
        assert type(ei.value).__name__ == "QuorumError"
    rng = np.random.default_rng(3)
    alphas = np.arange(1, 7, dtype=np.int64)
    values = byz._poly_eval(f, rng.integers(0, f.p, 4), alphas)
    values[[0, 2, 4]] = (values[[0, 2, 4]] + 1) % f.p
    with pytest.raises(AdversaryBudgetError, match="budget"):
        byz.locate_errors(f, alphas, values, 4, 1)
    with pytest.raises(Exception, match="budget"):
        jbyz.locate_errors(jf, alphas, values, 4, 1)


# ================================================================= MACs
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("p", PRIMES)
def test_tags_equal_jax_given_the_same_mac_params(scheme, p):
    jp, tp = protos(scheme, p, m=8)
    rng = np.random.default_rng(hash((scheme, p)) % 2**32)
    n, mt = tp.n_workers, 4
    i_pts = rng.integers(0, p, (n, mt, mt))
    gamma = int(rng.integers(1, p))
    offs = rng.integers(0, p, n)
    rvec = rng.integers(0, p, mt * mt)
    want = np.asarray(jp.plan.stages().tags(i_pts, gamma, offs, rvec))
    got = tp.plan.stages("cpu").tags(torch.from_numpy(i_pts), gamma,
                                     torch.from_numpy(offs),
                                     torch.from_numpy(rvec))
    np.testing.assert_array_equal(got.numpy(), want)
    # the batched stage: the same lanes, one launch
    lanes = np.stack([i_pts, (i_pts + 1) % p])
    v = tp.plan.batched("vtags", "cpu")(
        torch.from_numpy(lanes), torch.tensor([gamma, gamma]),
        torch.from_numpy(np.stack([offs, offs])),
        torch.from_numpy(np.stack([rvec, rvec])))
    np.testing.assert_array_equal(v[0].numpy(), want)
    np.testing.assert_array_equal(
        v[1].numpy(), np.asarray(jp.plan.stages().tags(lanes[1], gamma, offs,
                                                       rvec)))


def test_mac_params_and_check_localize_liars():
    _, tp = protos("age", P_DEFAULT)
    plan = tp.plan
    gamma, offs, rvec = byz.mac_params(plan, 7)
    assert 1 <= int(gamma) < plan.p
    assert offs.shape == (plan.n_workers,) and rvec.shape == (4,)
    again = byz.mac_params(plan, 7)
    assert all(torch.equal(x, y) for x, y in zip((gamma, offs, rvec), again,
                                                 strict=True))
    rng = np.random.default_rng(11)
    a, b = (torch.from_numpy(rng.integers(0, plan.p, (4, 4))) for _ in "ab")
    g = torch.Generator()
    g.manual_seed(0)
    i_pts = plan.stages("cpu").front(a, b, g)
    tags = byz.share_tags(plan, i_pts, 0)
    assert byz.check_shares(plan, i_pts, tags, 0).all()
    bad = i_pts.clone()
    bad[5] = (bad[5] + 1) % plan.p
    bad[12] = (bad[12] + 3) % plan.p
    honest = byz.check_shares(plan, bad, tags, 0)
    assert sorted(np.nonzero(~honest)[0]) == [5, 12]


# ======================================================= fault injector
@pytest.mark.parametrize("mode", ["tamper", "flip", "stale", "tag"])
def test_injector_log_and_deltas_equal_jax(mode):
    jp, tp = protos("age", P_DEFAULT)
    n = tp.n_workers
    rng = np.random.default_rng(4)
    kw = dict(seed=42, schedule={1: [(3, mode)], 2: [(0, mode), (16, mode)]},
              rate=0.25, slots=[1, 2, 5], mode=mode)
    ji, ti = JInjector(**kw), FaultInjector(**kw)
    for rnd in range(4):
        pts = rng.integers(0, tp.plan.p, (n, 2, 2))
        tags = rng.integers(0, tp.plan.p, n)
        jpts, jtags = ji.corrupt(jp.plan, pts, tags, rnd)
        tpts, ttags = ti.corrupt(tp.plan, torch.from_numpy(pts),
                                 torch.from_numpy(tags), rnd)
        np.testing.assert_array_equal(tpts.numpy(), np.asarray(jpts))
        np.testing.assert_array_equal(ttags.numpy(), np.asarray(jtags))
    assert ti.log == ji.log and ti.log
    assert ti.applied(2) == ji.applied(2)


def test_injector_json_round_trips_both_ways(tmp_path):
    kw = dict(seed=9, schedule={0: [(1, "tamper")], 4: [(2, "tag"),
                                                        (3, "stale")]},
              rate=0.5, slots=(0, 7), mode="flip")
    jdoc = JInjector(**kw).to_json()
    tdoc = FaultInjector(**kw).to_json()
    assert tdoc == jdoc
    assert FaultInjector.from_json(jdoc).to_json() == jdoc
    assert JInjector.from_json(tdoc).to_json() == tdoc
    JInjector(**kw).save(str(tmp_path / "s.json"))
    assert FaultInjector.load(str(tmp_path / "s.json")).to_json() == jdoc
    empty = FaultInjector.from_json({**jdoc, "schedule": []})
    assert empty.schedule is None
    with pytest.raises(ValueError, match="version"):
        FaultInjector.from_json({**jdoc, "version": 2})
    with pytest.raises(ValueError, match="mode"):
        FaultInjector(mode="gamma-ray")
    with pytest.raises(ValueError, match="rate"):
        FaultInjector(rate=1.5)


def test_injector_leaves_its_inputs_alone():
    _, tp = protos("age", P_DEFAULT)
    pts = torch.zeros((tp.n_workers, 2, 2), dtype=torch.int64)
    tags = torch.zeros(tp.n_workers, dtype=torch.int64)
    inj = FaultInjector(seed=1, schedule={0: [(3, "tamper"), (4, "tag")]})
    c_pts, c_tags = inj.corrupt(tp.plan, pts, tags, 0)
    assert not pts.any() and not tags.any()
    assert c_pts[3].all() and int(c_tags[4]) != 0
    same = inj.corrupt(tp.plan, pts, tags, 1)
    assert same[0] is pts and same[1] is tags


# ============================================ verified and corrected decode
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("p", PRIMES)
def test_run_verified_equals_jax_under_corruption(scheme, p):
    jp, tp = protos(scheme, p)
    rng = np.random.default_rng(hash((scheme, p, 1)) % 2**32)
    a = rng.integers(0, p, (4, 4))
    b = rng.integers(0, p, (4, 4))
    want = exact_ref(a, b, p)
    np.testing.assert_array_equal(tp.run(a, b, 1, device="cpu").numpy(), want)
    mask = np.ones(tp.n_workers, bool)
    mask[[0, tp.n_workers - 2]] = False
    cases = [([3], None), ([1, tp.n_workers - 1], None), ([2, 9], mask)]
    for rnd, (liars, surv) in enumerate(cases):
        for mode in ("tamper", "flip", "stale", "tag"):
            sched = {rnd: [(s, mode) for s in liars]}
            jy, jv = jp.run_verified(a, b, jax.random.PRNGKey(rnd),
                                     survivors=surv, round_id=rnd,
                                     injector=JInjector(seed=13,
                                                        schedule=sched))
            ty, tv = tp.run_verified(a, b, rnd, survivors=surv, round_id=rnd,
                                     injector=FaultInjector(seed=13,
                                                            schedule=sched),
                                     device="cpu")
            np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
            np.testing.assert_array_equal(ty.numpy(), want)
            assert tv.liars == jv.liars and tv.corrected == jv.corrected
            assert tv.quorum == jv.quorum


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("p", PRIMES)
def test_decode_corrected_equals_jax(scheme, p):
    jp, tp = protos(scheme, p)
    rng = np.random.default_rng(hash((scheme, p, 2)) % 2**32)
    a = rng.integers(0, p, (4, 4))
    b = rng.integers(0, p, (4, 4))
    g = torch.Generator()
    g.manual_seed(9)
    i_pts = tp.plan.stages("cpu").front(torch.from_numpy(a),
                                        torch.from_numpy(b), g).numpy().copy()
    i_pts[4] = (i_pts[4] + 7) % p
    i_pts[11] = (i_pts[11] ^ 1) % p
    mask = np.ones(tp.n_workers, bool)
    mask[0] = False
    for surv in (None, mask):
        jy, jl = jp.decode_corrected(i_pts, survivors=surv, seed=3)
        ty, tl = tp.decode_corrected(torch.from_numpy(i_pts), survivors=surv,
                                     seed=3)
        assert tl == jl and sorted(tl) == [4, 11]
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(ty.numpy(), exact_ref(a, b, p))


def test_verified_refusals_equal_jax():
    jp, tp = protos("age", P_DEFAULT)
    a = np.ones((4, 4), np.int64)
    sched = {0: [(1, "tamper"), (4, "tamper"), (8, "flip")]}
    with pytest.raises(AdversaryBudgetError, match="budget"):
        tp.run_verified(a, a, 0, device="cpu",
                        injector=FaultInjector(seed=1, schedule=sched))
    with pytest.raises(Exception, match="budget"):
        jp.run_verified(a, a, jax.random.PRNGKey(0),
                        injector=JInjector(seed=1, schedule=sched))
    mask = np.zeros(tp.n_workers, bool)
    mask[: tp.spec.verified_threshold - 1] = True
    with pytest.raises(QuorumError, match="verified quorum"):
        tp.run(a, a, 0, survivors=mask, device="cpu")
    assert len(tp.spec.validate_survivors(mask, corrected=True)) == 6
    with pytest.raises(ValueError, match="t²\\+z\\+2a"):
        MPCSpec(s=1, t=2, z=1, m=4, adversaries=3)
    s2 = MPCSpec(s=2, t=2, z=2, m=4, adversaries=2)
    j2 = JSpec(s=2, t=2, z=2, m=4, adversaries=2)
    assert s2.group_key() == j2.group_key()
    assert s2.verified_threshold == j2.verified_threshold == 10
    assert (AGECMPCProtocol.from_spec(s2).plan
            is AGECMPCProtocol.from_spec(s2.replace(adversaries=0)).plan)


# ============================================================== session
@pytest.mark.parametrize("backend", ["local", "batched"])
def test_session_corrects_and_evicts_like_jax(backend):
    spec = MPCSpec(s=2, t=2, z=2, m=4, adversaries=2)
    jspec = JSpec(s=2, t=2, z=2, m=4, adversaries=2)
    sched = {r: [(3, "tamper"), (9, "flip")] for r in range(64)}
    rng = np.random.default_rng(77)
    a = rng.integers(0, spec.field.p, (8, 8))
    b = rng.integers(0, spec.field.p, (8, 8))
    ref = np.array((a.astype(object) @ b.astype(object)) % spec.field.p,
                   np.int64)
    from repro.mpc import connect as jconnect

    jinj, tinj = JInjector(seed=5, schedule=sched), FaultInjector(
        seed=5, schedule=sched)
    js = jconnect(jspec, backend=backend, injector=jinj)
    ts = connect(spec, backend=backend, injector=tinj, device="cpu")
    np.testing.assert_array_equal(ts.matmul(a, b, encoded=True).numpy(), ref)
    np.testing.assert_array_equal(np.asarray(js.matmul(a, b, encoded=True)),
                                  ref)
    assert ts.stats == js.stats
    assert ts._dead == js._dead == {3, 9}
    assert tinj.log == jinj.log
    np.testing.assert_array_equal(ts.matmul(a, b, encoded=True).numpy(), ref)
    assert ts.stats["evicted_devices"] == 2


def test_session_pool_spec_evicts_roster_device_ids():
    spec = MPCSpec(s=2, t=2, z=2, m=4, adversaries=1,
                   pool=WorkerPool.homogeneous(20),
                   placement=tuple(range(19, 2, -1)))
    inj = FaultInjector(seed=3, schedule={0: [(4, "tamper")]})
    sess = connect(spec, backend="local", injector=inj, device="cpu")
    rng = np.random.default_rng(8)
    a = rng.integers(0, spec.field.p, (4, 4))
    b = rng.integers(0, spec.field.p, (4, 4))
    want = np.array((a.astype(object) @ b.astype(object)) % spec.field.p,
                    np.int64)
    np.testing.assert_array_equal(sess.matmul(a, b, encoded=True).numpy(),
                                  want)
    assert sess._dead == {15}
    assert sess.stats["evicted_devices"] == 1
    over = FaultInjector(seed=2, schedule={0: [(0, "tamper"), (5, "tamper")]})
    sess = connect(spec.replace(pool=None, placement=None), backend="local",
                   injector=over, device="cpu")
    with pytest.raises(QuorumError, match="budget"):
        sess.matmul(a, b, encoded=True)
    np.testing.assert_array_equal(sess.matmul(a, b, encoded=True).numpy(),
                                  want)
