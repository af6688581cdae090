"""The port's planner and protocol held against the JAX package.

Schemes × both primes × survivor masks: plan tables element-equal,
``plan_from_arrays`` round trips, ``Y`` integer-equal to JAX's fused run
(and to its pallas/reference runs where JAX defines them), and every stage
equal when both packages are given the same secrets and mask sums."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.mpc import AGECMPCProtocol as JProto
from repro.mpc import Field as JField
from repro.mpc.field import P_DEFAULT, P_MERSENNE31
from repro_torch.mpc import AGECMPCProtocol, Field, plan_from_arrays
from repro_torch.mpc.errors import MaskShapeError, QuorumError
from repro_torch.mpc.planner import SOLVE_CACHE_SIZE, ProtocolStages

SCHEMES = ["age", "entangled", "polydot"]
PRIMES = [P_DEFAULT, P_MERSENNE31]
MASKS = ["all", "prefix", "random"]
TABLES = ("alphas", "powers_h", "r_coeffs", "vand_a", "vand_b", "g_mix",
          "vand_g_secret", "decode_rows")
S, T_, Z, M = 2, 2, 2, 8


def protos(scheme, p):
    kw = dict(s=S, t=T_, z=Z, m=M, scheme=scheme)
    return JProto(field=JField(p), **kw), AGECMPCProtocol(field=Field(p), **kw)


def mask_for(kind, n, t2z, seed=0):
    if kind == "all":
        return None
    alive = np.ones(n, bool)
    if kind == "prefix":
        alive[: n - t2z] = False
    else:
        rng = np.random.default_rng(seed)
        alive[:] = False
        alive[rng.choice(n, t2z, replace=False)] = True
    return alive


def exact(a, b, p):
    return np.array((a.T.astype(object) @ b.astype(object)) % p, np.int64)


def plan_arrays(jplan):
    return dict(scheme=jplan.scheme, s=jplan.s, t=jplan.t, z=jplan.z,
                alpha=jplan.code.alpha, beta=jplan.code.beta,
                theta=jplan.code.theta, p=jplan.p, m=jplan.m,
                **{k: getattr(jplan, k) for k in TABLES})


def jax_draws(key, p, z, mt, ms):
    """The secrets and mask sum JAX's fused stages draw from ``key``."""
    k1, k2 = jax.random.split(key)
    ka, kb = jax.random.split(k1)
    sec_a = jax.random.randint(ka, (z, mt, ms), 0, p, dtype=jnp.int64)
    sec_b = jax.random.randint(kb, (z, ms, mt), 0, p, dtype=jnp.int64)
    mask = (jax.random.bits(k2, (z, mt, mt), jnp.uint64)
            % jnp.uint64(p)).astype(jnp.int64)
    return k1, k2, np.asarray(sec_a), np.asarray(sec_b), np.asarray(mask)


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_plan_tables_equal_and_round_trip(scheme, p):
    jp, tp = protos(scheme, p)
    for k in TABLES:
        np.testing.assert_array_equal(getattr(tp.plan, k), getattr(jp.plan, k))
    assert tp.plan.n_workers == jp.plan.n_workers
    assert tp.code.n_workers == jp.code.n_workers
    rt = plan_from_arrays(**plan_arrays(jp.plan))
    for k in TABLES:
        np.testing.assert_array_equal(getattr(rt, k), getattr(jp.plan, k))
    # the round-tripped tables drive the port's stages to the same Y
    rng = np.random.default_rng(1)
    a, b = rng.integers(0, p, (M, M)), rng.integers(0, p, (M, M))
    g = torch.Generator()
    g.manual_seed(5)
    y = rt.stages("cpu").fused(torch.from_numpy(a), torch.from_numpy(b), g)
    np.testing.assert_array_equal(y.numpy(), exact(a, b, p))
    # survivor solves, spare points and quorum weights agree too
    n, t2z = tp.n_workers, tp.recovery_threshold
    idx = tuple(range(n - t2z, n))
    np.testing.assert_array_equal(tp.plan.survivor_rows(idx),
                                  jp.plan.survivor_rows(idx))
    np.testing.assert_array_equal(tp.plan.pool_alphas(n + 3),
                                  jp.plan.pool_alphas(n + 3))
    q = tuple(range(3, n + 3))
    np.testing.assert_array_equal(tp.plan.quorum_weights(q, n + 3),
                                  jp.plan.quorum_weights(q, n + 3))
    tp.check_privacy_structure(n_subsets=8)


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_y_equals_jax_across_modes(scheme, p, mask):
    jp, tp = protos(scheme, p)
    surv = mask_for(mask, tp.n_workers, tp.recovery_threshold,
                    seed=len(scheme) + p % 7)
    rng = np.random.default_rng(
        10 * SCHEMES.index(scheme) + MASKS.index(mask) + p % 7)
    a, b = rng.integers(0, p, (M, M)), rng.integers(0, p, (M, M))
    want = np.asarray(jp.run(a, b, jax.random.PRNGKey(3), survivors=surv))
    np.testing.assert_array_equal(want, exact(a, b, p))
    for mode in ("fused", "kernel"):
        got = tp.run(a, b, 11, survivors=surv, mode=mode, device="cpu")
        assert got.dtype == torch.int64 and got.shape == (M, M)
        np.testing.assert_array_equal(got.numpy(), want)
    if p == P_DEFAULT:   # JAX defines pallas/reference for this window only
        np.testing.assert_array_equal(
            tp.run(a, b, 4, survivors=surv, mode="reference",
                   device="cpu").numpy(),
            np.asarray(jp.run(a, b, jax.random.PRNGKey(4), survivors=surv,
                              mode="reference")))
        np.testing.assert_array_equal(
            tp.run(a, b, 5, survivors=surv, mode="kernel",
                   device="cpu").numpy(),
            np.asarray(jp.run(a, b, jax.random.PRNGKey(5), survivors=surv,
                              mode="pallas")))
    else:
        with pytest.raises(ValueError, match="acc_window"):
            tp.run(a, b, 4, mode="reference", device="cpu")


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_stages_equal_jax_given_its_draws(scheme, p):
    jp, tp = protos(scheme, p)
    mt, ms = M // T_, M // S
    rng = np.random.default_rng(7)
    a, b = rng.integers(0, p, (M, M)), rng.integers(0, p, (M, M))
    k1, k2, sec_a, sec_b, mask = jax_draws(jax.random.PRNGKey(9), p, Z, mt, ms)
    js, ts = jp.plan.stages(), tp.plan.stages("cpu")
    at, bt = torch.from_numpy(a), torch.from_numpy(b)

    jfa, jfb = js.encode(jnp.asarray(a), jnp.asarray(b), k1)
    tfa, tfb = ts.encode(at, bt, None, secrets=(sec_a, sec_b))
    np.testing.assert_array_equal(tfa.numpy(), np.asarray(jfa))
    np.testing.assert_array_equal(tfb.numpy(), np.asarray(jfb))

    jh = js.worker_compute(jfa, jfb)
    th = ts.worker_compute(tfa, tfb)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))

    ji = js.exchange(jh, k2)
    ti = ts.exchange(th, None, mask_sum=mask)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    n, t2z = tp.n_workers, tp.recovery_threshold
    idx = tuple(sorted(np.random.default_rng(2).choice(n, t2z, replace=False)))
    j_idx, j_rows = jp.plan.survivor_tables(idx)
    t_idx, t_rows = tp.plan.survivor_tables(idx, "cpu")
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(j_rows))
    jy = js.decode(ji, j_idx, j_rows)
    ty = ts.decode(ti, t_idx, t_rows)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(ty.numpy(), exact(a, b, p))

    gamma = int(rng.integers(0, p))
    offsets = rng.integers(0, p, n)
    rvec = rng.integers(0, p, mt * mt)
    jt = js.tags(ji, jnp.int64(gamma), jnp.asarray(offsets), jnp.asarray(rvec))
    tt = ts.tags(ti, gamma, torch.from_numpy(offsets), rvec)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_decode_entry_and_phase_helpers_equal_jax():
    jp, tp = protos("age", P_DEFAULT)
    mt, ms = M // T_, M // S
    rng = np.random.default_rng(4)
    a, b = rng.integers(0, P_DEFAULT, (M, M)), rng.integers(0, P_DEFAULT, (M, M))
    _, _, sec_a, sec_b, mask = jax_draws(jax.random.PRNGKey(1), P_DEFAULT, Z,
                                         mt, ms)
    ts = tp.plan.stages("cpu")
    i_pts = ts.exchange(ts.worker_compute(*ts.encode(
        torch.from_numpy(a), torch.from_numpy(b), None,
        secrets=(sec_a, sec_b))), None, mask_sum=mask)
    surv = mask_for("random", tp.n_workers, tp.recovery_threshold, seed=3)
    np.testing.assert_array_equal(tp.decode(i_pts, surv).numpy(),
                                  np.asarray(jp.decode(i_pts.numpy(), surv)))
    np.testing.assert_array_equal(tp.decode(i_pts.numpy(), surv,
                                            device="cpu").numpy(),
                                  exact(a, b, P_DEFAULT))
    # the reference helpers compose to the same Y as the staged path
    g = torch.Generator()
    g.manual_seed(0)
    fa, fb = tp.phase1_shares(torch.from_numpy(a), torch.from_numpy(b), g)
    h = tp.phase2_compute(fa, fb)
    np.testing.assert_array_equal(h.numpy(), tp.phase2_compute(
        fa, fb, use_kernel=True).numpy())
    y = tp._decode_seed(tp.phase2_exchange(h, g))
    np.testing.assert_array_equal(y.numpy(), exact(a, b, P_DEFAULT))


def test_survivor_validation_and_cache():
    _, tp = protos("age", P_DEFAULT)
    n, t2z = tp.n_workers, tp.recovery_threshold
    a = np.zeros((M, M), np.int64)
    with pytest.raises(MaskShapeError):
        tp.run(a, a, 0, survivors=np.ones(n + 1, bool), device="cpu")
    short = np.zeros(n, bool)
    short[: t2z - 1] = True
    for mode in ("fused", "kernel", "reference"):
        with pytest.raises(QuorumError):
            tp.run(a, a, 0, survivors=short, mode=mode, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        tp.run(a, a, 0, mode="pallas", device="cpu")
    plan = tp.plan
    before = plan.solve_cache_info()
    idx = tuple(range(1, t2z + 1))
    plan.survivor_rows(idx)
    plan.survivor_rows(idx)
    after = plan.solve_cache_info()
    assert after["hits"] - before["hits"] == 1
    assert after["size"] <= SOLVE_CACHE_SIZE
    assert plan.survivor_rows(tuple(range(t2z))) is plan.decode_rows
    assert plan.stages("cpu") is plan.stages("cpu")
    assert plan.tables("cpu")["g_mix_t"].shape == (n, n)


def test_generator_keys_and_not_ported_options():
    _, tp = protos("polydot", P_MERSENNE31)
    rng = np.random.default_rng(0)
    a = rng.integers(0, P_MERSENNE31, (M, M))
    g = torch.Generator()
    g.manual_seed(42)
    y = tp.run(torch.from_numpy(a), torch.from_numpy(a), g)   # CPU tensors
    np.testing.assert_array_equal(y.numpy(), exact(a, a, P_MERSENNE31))
    # the adversary budget and pool placements (items 6 and 7) now work:
    # a verified run and a placed protocol give the exact product
    b = rng.integers(0, P_MERSENNE31, (M, M))
    verified = AGECMPCProtocol(s=2, t=2, z=2, m=8, adversaries=1,
                               field=Field(P_MERSENNE31))
    np.testing.assert_array_equal(
        verified.run(a, b, 3, device="cpu").numpy(),
        exact(a, b, P_MERSENNE31))
    from repro_torch.mpc import WorkerPool

    placed = AGECMPCProtocol(s=2, t=2, z=2, m=8, pool=WorkerPool.homogeneous(
        20), placement=tuple(range(19, 2, -1)))
    assert placed.spec.effective_placement == tuple(range(19, 2, -1))
    assert placed.plan is AGECMPCProtocol(s=2, t=2, z=2, m=8).plan
    # ProtocolStages.timed (item 10) records each stage it is given
    from repro_torch.sim import PhaseRecorder

    rec = PhaseRecorder()
    timed = ProtocolStages.timed(tp.plan.stages("cpu"), rec, plan=tp.plan)
    np.testing.assert_array_equal(
        timed.fused(torch.from_numpy(a), torch.from_numpy(b), g).numpy(),
        exact(a, b, P_MERSENNE31))
    assert [(r.phase, r.device, r.klass) for r in rec.samples] == [
        ("fused", -1, "polydot")]
    assert rec.samples[0].scalars > 0 and timed.device == torch.device("cpu")
