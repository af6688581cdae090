"""The port's session API held against the JAX session on the same inputs.

``connect(spec, device="cpu").matmul`` must equal ``repro.mpc.connect``'s
result exactly: field outputs as integers and float outputs bit for bit
(encode, ``Y`` and decode are all exact), for square, rectangular, batched
and vector operands, with survivor masks, through ``submit``/``flush`` and
after ``fail()``."""
import jax
import numpy as np
import pytest
import torch

from repro.mpc import Field as JField
from repro.mpc import MPCSpec as JSpec
from repro.mpc import connect as jconnect
from repro.mpc.field import P_DEFAULT, P_MERSENNE31
from repro_torch.mpc import Field, MPCSpec, QuorumError, connect
from repro_torch.mpc.backends import LocalBackend, resolve_backend

SCHEMES = ["age", "entangled", "polydot"]
PRIMES = [P_DEFAULT, P_MERSENNE31]

SHAPES = {
    "square": ((16, 16), (16, 16)),
    "rect": ((5, 12), (12, 7)),
    "wide": ((1, 10), (10, 37)),
    "batched": ((3, 4, 6), (3, 6, 5)),
    "broadcast": ((2, 1, 3, 8), (4, 8, 3)),
    "lead": ((2, 3, 9), (9, 4)),
    "vec_mat": ((6,), (6, 5)),
    "mat_vec": ((5, 6), (6,)),
    "vec_vec": ((7,), (7,)),
}


def sessions(p=P_DEFAULT, scheme="age", s=2, t=2, z=2, **kw):
    js = jconnect(JSpec(s=s, t=t, z=z, scheme=scheme, field=JField(p)), **kw)
    ts = connect(MPCSpec(s=s, t=t, z=z, scheme=scheme, field=Field(p)),
                 device="cpu", **kw)
    return js, ts


def exact(a, b, p):
    return np.array((a.astype(object) @ b.astype(object)) % p, np.int64)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_float_matmul_equals_jax_bit_for_bit(shape):
    sa, sb = SHAPES[shape]
    rng = np.random.default_rng(len(shape))
    a = rng.normal(size=sa).astype(np.float32)
    b = rng.normal(size=sb).astype(np.float32)
    js, ts = sessions()
    want = np.asarray(js.matmul(a, b))
    got = ts.matmul(a, b)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.shape == want.shape == np.matmul(a, b).shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(got.numpy() - np.matmul(a, b)).max() < 0.1


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_encoded_matmul_exact_and_equal_jax(scheme, p):
    rng = np.random.default_rng(p % 1000 + len(scheme))
    a = rng.integers(0, p, (6, 20))
    b = rng.integers(0, p, (20, 9))
    js, ts = sessions(p, scheme)
    got = ts.matmul(a, b, encoded=True).numpy()
    np.testing.assert_array_equal(got, exact(a, b, p))
    np.testing.assert_array_equal(got, np.asarray(js.matmul(a, b,
                                                            encoded=True)))


@pytest.mark.parametrize("mode", ["fused", "kernel", "reference"])
def test_modes_and_explicit_block_agree(mode):
    rng = np.random.default_rng(3)
    a = rng.integers(0, P_DEFAULT, (10, 12))
    b = rng.integers(0, P_DEFAULT, (12, 8))
    ts = connect(MPCSpec(s=2, t=2, z=1), device="cpu", mode=mode)
    for m in (None, 4, 16):
        np.testing.assert_array_equal(
            ts.matmul(a, b, encoded=True, m=m).numpy(), exact(a, b, P_DEFAULT))


@pytest.mark.parametrize("kind", ["prefix", "random"])
def test_survivor_masks_equal_jax(kind):
    rng = np.random.default_rng(11)
    a = rng.normal(size=(7, 12)).astype(np.float32)
    b = rng.normal(size=(12, 5)).astype(np.float32)
    js, ts = sessions(scheme="entangled")
    n, t2z = ts.spec.n_workers, ts.spec.recovery_threshold
    alive = np.ones(n, bool)
    if kind == "prefix":
        alive[: n - t2z] = False
    else:
        alive[:] = False
        alive[rng.choice(n, t2z, replace=False)] = True
    np.testing.assert_array_equal(ts.matmul(a, b, survivors=alive).numpy(),
                                  np.asarray(js.matmul(a, b, survivors=alive)))
    short = alive.copy()
    short[np.nonzero(short)[0][0]] = False
    with pytest.raises(QuorumError):
        ts.matmul(a, b, survivors=short)


def test_exact_fit_single_block_consumes_the_key():
    """A square m×m call is one protocol run on the caller's key."""
    rng = np.random.default_rng(2)
    a = rng.integers(0, P_DEFAULT, (8, 8))
    b = rng.integers(0, P_DEFAULT, (8, 8))
    ts = connect(MPCSpec(s=2, t=2, z=2, m=8), device="cpu")
    y = ts.matmul(a, b, encoded=True, key=5)
    assert ts.stats["blocks"] == 1
    proto = ts.spec.protocol()
    np.testing.assert_array_equal(
        y.numpy(), proto.run(a.T.copy(), b, 5, device="cpu").numpy())
    g = torch.Generator()
    g.manual_seed(9)
    np.testing.assert_array_equal(
        ts.matmul(a, b, encoded=True, key=g).numpy(), exact(a, b, P_DEFAULT))


def test_submit_flush_and_fail_folding():
    rng = np.random.default_rng(8)
    js, ts = sessions(scheme="polydot", key=None)
    ops = [(rng.normal(size=(3, 10)), rng.normal(size=(10, 4)))
           for _ in range(3)]
    rids = [ts.submit(a, b) for a, b in ops]
    jrids = [js.submit(a, b) for a, b in ops]
    assert ts.pending() == 3
    out, jout = ts.flush(), js.flush()
    assert ts.pending() == 0 and ts.failures == {}
    for rid, jrid in zip(rids, jrids, strict=True):
        np.testing.assert_array_equal(out[rid].numpy(), np.asarray(jout[jrid]))
    assert ts.stats["matmuls"] == 3 and ts.stats["flushes"] == 1
    n, t2z = ts.spec.n_workers, ts.spec.recovery_threshold
    dead = list(range(n - t2z))
    ts.fail(dead[:2])
    ts.fail(dead[2:])
    js.fail(dead)
    a, b = ops[0]
    np.testing.assert_array_equal(ts.matmul(a, b).numpy(),
                                  np.asarray(js.matmul(a, b)))
    ts.fail([n - 1])       # below the decode quorum now
    with pytest.raises(QuorumError):
        ts.matmul(a, b)
    rid = ts.submit(a, b)
    assert ts.flush() == {} and rid in ts.failures


def test_empty_and_misaligned_operands():
    _, ts = sessions()
    assert ts.matmul(np.zeros((0, 4)), np.zeros((4, 3))).shape == (0, 3)
    np.testing.assert_array_equal(
        ts.matmul(np.zeros((2, 0)), np.zeros((0, 3)), encoded=True).numpy(),
        np.zeros((2, 3), np.int64))
    with pytest.raises(ValueError, match="align"):
        ts.matmul(np.zeros((2, 3)), np.zeros((4, 3)))


def test_not_ported_options_raise():
    # items 6 to 9 are ported: budgets, pools, tuning, cost-model block
    # search and the batched, remote and sharded backends work and equal
    # the reference; nothing in the session refuses any more
    from repro_torch.mpc import CostModel, WorkerPool
    from repro_torch.mpc.backends import BatchedBackend

    assert MPCSpec(s=2, t=2, z=2, adversaries=1).verified_threshold == 8
    with pytest.raises(TypeError, match="WorkerPool"):
        MPCSpec(s=2, t=2, z=2, pool=object())
    pooled = MPCSpec(s=2, t=2, z=2, pool=WorkerPool.homogeneous(17))
    assert pooled.effective_placement == tuple(range(17))
    tuned = MPCSpec.tune(17, 2, (4, 4, 4))
    want = JSpec.tune(17, 2, (4, 4, 4))
    assert tuned.plan_key() == want.plan_key()
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((3, 8)), rng.standard_normal((8, 5))
    for kw in ({"cost": CostModel()}, {"backend": "batched"}):
        y = connect(MPCSpec(s=2, t=2, z=2), device="cpu", **kw).matmul(a, b)
        np.testing.assert_allclose(y.numpy(), a @ b, atol=0.05)
    assert isinstance(connect(MPCSpec(s=2, t=2, z=2), backend="batched",
                              device="cpu").backend, BatchedBackend)
    # the sharded backend (item 8) serves on its mesh's first device
    from repro_torch.parallel import make_mesh

    mesh = make_mesh((2,), ("model",), devices=["cpu"] * 2)
    sharded = connect(MPCSpec(s=2, t=2, z=2), backend="sharded", mesh=mesh)
    assert sharded.device == torch.device("cpu")
    y = sharded.matmul(a, b)
    assert y.device == torch.device("cpu")
    np.testing.assert_allclose(y.numpy(), a @ b, atol=0.05)
    with pytest.raises(ValueError, match="mesh="):
        connect(MPCSpec(s=2, t=2, z=2), backend="sharded", device="cpu")
    # the remote backend (item 9) serves on the session's device, and
    # refuses a Byzantine budget as the reference does
    remote = connect(MPCSpec(s=2, t=2, z=2), backend="remote", device="cpu")
    try:
        y = remote.matmul(a, b)
        assert y.device == torch.device("cpu")
        np.testing.assert_allclose(y.numpy(), a @ b, atol=0.05)
    finally:
        remote.backend.close()
    with pytest.raises(ValueError, match="does not verify"):
        connect(MPCSpec(s=2, t=2, z=2, adversaries=1), backend="remote",
                device="cpu")
    with pytest.raises(ValueError, match="mode"):
        LocalBackend(mode="pallas")
    be = LocalBackend(mode="kernel")
    assert resolve_backend(be) is be
    with pytest.raises(ValueError, match="positive"):
        connect(MPCSpec(s=2, t=2, z=2), device="cpu", tile_budget=0)


def test_spec_surface_matches_jax():
    for scheme in SCHEMES:
        j = JSpec(s=2, t=3, z=2, scheme=scheme, m=12)
        t = MPCSpec(s=2, t=3, z=2, scheme=scheme, m=12)
        assert t.plan_key() == j.plan_key() == t.group_key()
        assert t.n_workers == j.n_workers
        assert t.recovery_threshold == j.recovery_threshold
        np.testing.assert_array_equal(t.validate_survivors(None),
                                      j.validate_survivors(None))
        assert t.protocol().plan is t.plan()
    with pytest.raises(ValueError, match=r"s\|m"):
        MPCSpec(s=2, t=3, z=1, m=8)
    with pytest.raises(ValueError, match="block size"):
        MPCSpec(s=2, t=2, z=2).plan_key()
    jax.numpy.zeros(1)  # JAX stays importable beside torch in one process
