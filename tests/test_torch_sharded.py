"""The port's sharded runner held against the JAX ``ShardedCMPC``.

The JAX runner needs several devices, so it runs in one subprocess with
eight forced host devices (as ``tests/test_sharded_mpc.py`` runs it); it
writes ``build_step()``'s I-points for numpy-seeded terms and masks to
``tmp_path``, and the port's ``step`` on ``["cpu"] * D`` must equal them
as integers.  Every case is also held to an exact object-dtype evaluation
of the same step.  For Mersenne-31 only that oracle holds the port: the
JAX runner's int64 einsums (phase 1 and the G-mix) sum products of up to
2^62 without a fold and wrap, so its M31 I-points (and ``Y``) are not
exact; the port folds inside its kernels at ``acc_window(p)``.

Also here: ``Y`` of the full run (with and without ``prg_masks``, both
wires, an odd mesh size) exact and equal to the local backend; the ring
reduce-scatter against the int64 sum-scatter; ``ring_fold_plain`` at the
all-(p-1) corner; and the port counterparts of ``tests/test_api.py``'s
backend agreement and shim tests, ``tests/test_workers.py``'s sharded
dispatch scale and ``tests/test_byzantine.py``'s rejection."""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.mpc import MPCSpec as JSpec
from repro.mpc import connect as jconnect
from repro.mpc.field import P_DEFAULT, P_MERSENNE31
from repro_torch.kernels.ring_fold import ring_fold, ring_fold_plain
from repro_torch.mpc import (
    AGECMPCProtocol,
    CostModel,
    FaultInjector,
    Field,
    MPCSpec,
    connect,
)
from repro_torch.mpc.backends import ShardedBackend
from repro_torch.mpc.secure_matmul import (
    ShardedCMPC,
    mod_ring_reduce_scatter,
    psum_scatter,
    secure_matmul,
)
from repro_torch.parallel import Mesh, make_mesh, shard_map

SCHEMES = ["age", "entangled", "polydot"]
PRIMES = [P_DEFAULT, P_MERSENNE31]
SIZES = [1, 2, 4, 8]
WIRES = ["int64", "int32"]
M = 8                                   # s = t = 2: blocks of 4 x 4
CASES = [(scheme, p, d, wire) for scheme in SCHEMES for p in PRIMES
         for d in SIZES for wire in WIRES]

JAX_SCRIPT = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax
    from jax.sharding import Mesh
    from repro.mpc import AGECMPCProtocol
    from repro.mpc.field import Field
    from repro.mpc.secure_matmul import ShardedCMPC

    src, dst = sys.argv[1], sys.argv[2]
    cases = json.load(open(src + ".json"))
    data = np.load(src)
    out = {}
    for name, (scheme, p, d, wire) in cases.items():
        proto = AGECMPCProtocol(s=2, t=2, z=2, m=%d, scheme=scheme,
                                field=Field(p))
        mesh = Mesh(np.array(jax.devices()[:d]), ("model",))
        sh = ShardedCMPC(proto, mesh, "model", wire_dtype=wire)
        step = sh.build_step()
        out[name] = np.asarray(step(data[name + "_ta"], data[name + "_tb"],
                                    data[name + "_mk"]))
    np.savez(dst, **out)
    print("JAX_STEP_OK")
    """ % M)


def case_name(scheme, p, d, wire):
    return f"{scheme}_{p}_{d}_{wire}"


def runner(scheme, p, d, wire="int64", prg=False):
    proto = AGECMPCProtocol(s=2, t=2, z=2, m=M, scheme=scheme, field=Field(p))
    mesh = make_mesh((d,), ("model",), devices=["cpu"] * d)
    return ShardedCMPC(proto, mesh, "model", wire_dtype=wire, prg_masks=prg)


def inputs(sh, seed):
    """Terms and masks of one case, drawn with numpy, in the wire's type."""
    pr = sh.proto
    p, k = pr.field.p, pr.s * pr.t + pr.z
    mt, ms = M // pr.t, M // pr.s
    rng = np.random.default_rng(seed)
    dt = np.int32 if sh.wire_dtype == "int32" else np.int64
    ta = rng.integers(0, p, (k, mt, ms)).astype(dt)
    tb = rng.integers(0, p, (k, ms, mt)).astype(dt)
    mk = rng.integers(0, p, (sh.n_pad, pr.z, mt, mt)).astype(dt)
    return ta, tb, mk


def oracle(sh, ta, tb, mk):
    """The step's I-points in Python integers (object dtype): no overflow
    at any prime."""
    c = {k: v.astype(object) for k, v in sh._consts().items()}
    pr = sh.proto
    p, n = pr.field.p, sh.n_pad
    mt, ms = M // pr.t, M // pr.s
    f_a = ((c["vand_a"] @ ta.astype(object).reshape(len(ta), -1)) % p
           ).reshape(n, mt, ms)
    f_b = ((c["vand_b"] @ tb.astype(object).reshape(len(tb), -1)) % p
           ).reshape(n, ms, mt)
    h = np.stack([(f_a[w] @ f_b[w]) % p for w in range(n)]).reshape(n, -1)
    mask_sum = mk.astype(object).sum(axis=0).reshape(pr.z, -1) % p
    i_pts = (c["g_mix"].T @ h + c["vand_g"] @ mask_sum) % p
    return i_pts.reshape(n, mt, mt).astype(np.int64)


@pytest.fixture(scope="module")
def jax_ipoints(tmp_path_factory):
    """The JAX runner's I-points for every p = 2^26 - 5 case, from one
    subprocess with eight forced host devices."""
    tmp = tmp_path_factory.mktemp("sharded")
    src, dst = str(tmp / "in.npz"), str(tmp / "out.npz")
    cases, arrays = {}, {}
    for i, (scheme, p, d, wire) in enumerate(CASES):
        if p != P_DEFAULT:
            continue
        name = case_name(scheme, p, d, wire)
        cases[name] = [scheme, p, d, wire]
        ta, tb, mk = inputs(runner(scheme, p, d, wire), seed=i)
        arrays.update({name + "_ta": ta, name + "_tb": tb, name + "_mk": mk})
    np.savez(src, **arrays)
    with open(src + ".json", "w") as f:
        json.dump(cases, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src"))
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT, src, dst], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "JAX_STEP_OK" in res.stdout
    return dict(np.load(dst))


# ------------------------------------------------------------- I-points
@pytest.mark.parametrize("scheme,p,d,wire", CASES)
def test_step_ipoints_equal_jax(jax_ipoints, scheme, p, d, wire):
    sh = runner(scheme, p, d, wire)
    assert sh.n_pad % d == 0 and sh.n_pad >= sh.proto.n_workers
    ta, tb, mk = inputs(sh, seed=CASES.index((scheme, p, d, wire)))
    got = sh.build_step()(ta, tb, mk)
    assert got.dtype == torch.int64 and got.shape == (sh.n_pad, 4, 4)
    np.testing.assert_array_equal(got.numpy(), oracle(sh, ta, tb, mk))
    if p == P_DEFAULT:
        np.testing.assert_array_equal(
            got.numpy(), jax_ipoints[case_name(scheme, p, d, wire)])


def test_padding_of_n17_over_four_shards():
    sh = runner("age", P_DEFAULT, 4)
    assert (sh.proto.n_workers, sh.axis_size, sh.n_pad) == (17, 4, 20)
    c = sh._consts()
    assert c["vand_a"].shape == (20, 6) and not c["vand_a"][17:].any()
    assert c["g_mix"].shape == (20, 20)
    assert not c["g_mix"][17:].any() and not c["g_mix"][:, 17:].any()
    tab = sh._shard_tables
    # each shard's exchange: [g_mix_t[:, local] | vand_g once per local
    # worker], K = 5 (1 + z) = 15
    assert [t["exchange"].shape for t in tab] == [(20, 15)] * 4
    np.testing.assert_array_equal(tab[1]["exchange"][:, :5].numpy(),
                                  c["g_mix"][5:10].T)
    np.testing.assert_array_equal(tab[3]["exchange"][:, 5:7].numpy(),
                                  c["vand_g"])


def test_prg_masks_are_each_workers_own_draw():
    """With ``prg_masks`` each worker's mask is ``randint(0, p)`` from a
    generator seeded with its own seed, on its shard's device: equal to
    passing those masks explicitly."""
    sh = runner("age", P_DEFAULT, 4, prg=True)
    plain = runner("age", P_DEFAULT, 4)
    ta, tb, _ = inputs(sh, seed=3)
    seeds = [101 + 7 * w for w in range(sh.n_pad)]
    masks = []
    for s in seeds:
        g = torch.Generator().manual_seed(s)
        masks.append(torch.randint(0, P_DEFAULT, (2, 4, 4), generator=g))
    np.testing.assert_array_equal(
        sh.build_step()(ta, tb, seeds).numpy(),
        plain.build_step()(ta, tb, torch.stack(masks)).numpy())


# ------------------------------------------------------------------ Y
@pytest.mark.parametrize("wire,prg", [("int64", False), ("int32", False),
                                      ("int64", True), ("int32", True)])
@pytest.mark.parametrize("d", [1, 3, 8])
@pytest.mark.parametrize("p", PRIMES)
def test_run_y_exact_and_equals_local(p, d, wire, prg):
    sh = runner("age", p, d, wire, prg)
    rng = np.random.default_rng(d)
    a, b = rng.integers(0, p, (M, M)), rng.integers(0, p, (M, M))
    want = np.array((a.astype(object).T @ b.astype(object)) % p, np.int64)
    y = sh.run(a, b, 5)
    np.testing.assert_array_equal(y.numpy(), want)
    local = sh.proto.run(a, b, 5, device="cpu")
    np.testing.assert_array_equal(y.numpy(), local.numpy())
    alive = np.ones(sh.proto.n_workers, bool)
    alive[[0, 3, 4, 9, 11, 12, 16]] = False            # 10 of 17 left
    np.testing.assert_array_equal(sh.run(a, b, 6, survivors=alive).numpy(),
                                  want)


# ----------------------------------------------------------------- ring
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("d", [2, 3, 4, 8])
@pytest.mark.parametrize("p", PRIMES)
def test_ring_reduce_scatter_equals_sum_scatter(p, d, dtype):
    rng = np.random.default_rng(d)
    xs = [torch.from_numpy(rng.integers(0, p, (d * 3, 5))).to(dtype)
          for _ in range(d)]
    before = [x.clone() for x in xs]
    got = mod_ring_reduce_scatter(xs, p)
    want = psum_scatter([x.to(torch.int64) for x in xs], p)
    total = sum(x.numpy().astype(object) for x in xs) % p
    for me in range(d):
        assert got[me].dtype == dtype and got[me].shape == (3, 5)
        np.testing.assert_array_equal(got[me].to(torch.int64).numpy(),
                                      want[me].numpy())
        np.testing.assert_array_equal(want[me].numpy(),
                                      total[3 * me:3 * me + 3].astype(np.int64))
    # one device repeated: no hop wrote into a chunk another shard reads
    for x, x0 in zip(xs, before, strict=True):
        assert torch.equal(x, x0)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("p", PRIMES)
def test_ring_fold_all_p_minus_1_corner(p, dtype):
    x = torch.full((3, 1001), p - 1, dtype=dtype)     # odd C
    for fold in (ring_fold, ring_fold_plain):
        out = fold(x, x, p=p)
        assert out.dtype == dtype
        assert bool((out == p - 2).all())              # 2 (p-1) mod p
        assert out.data_ptr() not in (x.data_ptr(),)
    rng = np.random.default_rng(p % 97)
    a, b = (rng.integers(0, p, 777) for _ in range(2))
    got = ring_fold(torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype),
                    p=p)
    np.testing.assert_array_equal(got.to(torch.int64).numpy(), (a + b) % p)
    with pytest.raises(TypeError, match="int32 or int64"):
        ring_fold(x.float(), x.float(), p=p)
    with pytest.raises(ValueError, match="one shape"):
        ring_fold(x, x[:, :5].contiguous(), p=p)


# ------------------------------------------------------------ the mesh
def test_mesh_and_shard_map():
    mesh = make_mesh((2, 3), ("data", "model"), devices=["cpu"] * 6)
    assert isinstance(mesh, Mesh)
    assert mesh.shape == {"data": 2, "model": 3} and len(mesh.devices) == 6
    assert mesh.axis_devices("model") == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="no axis"):
        mesh.axis_devices("expert")
    with pytest.raises(ValueError, match="devices for a mesh"):
        make_mesh((4,), ("model",), devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make_mesh((2,), ("model",))
    calls = shard_map(lambda i, dev, x: (i, dev.type, x), mesh, "model")(7)
    assert calls == [(0, "cpu", 7), (1, "cpu", 7), (2, "cpu", 7)]
    with pytest.raises(ValueError, match="wire_dtype"):
        runner("age", P_DEFAULT, 2, wire="int16")
    with pytest.raises(ValueError, match="disagrees"):
        connect(MPCSpec(s=2, t=2, z=2), backend="sharded",
                mesh=make_mesh((2,), ("model",), devices=["cpu"] * 2),
                device="meta")


# ------------------------------------------- the session's sharded backend
def test_backends_bit_agree_rectangular_float():
    """[1,D] x [D,V] floats, D and V not multiples of s·t: bit for bit equal
    across the port's local, batched and sharded backends and the JAX
    local backend."""
    spec = MPCSpec(s=2, t=2, z=2)
    rng = np.random.default_rng(7)
    d, v = 13, 29
    a = rng.standard_normal((1, d)).astype(np.float32)
    b = rng.standard_normal((d, v)).astype(np.float32)
    outs = {}
    for name, opts in [("local", {"device": "cpu"}),
                       ("batched", {"device": "cpu"}),
                       ("sharded 1", {"mesh": make_mesh((1,), ("model",),
                                                        devices=["cpu"])}),
                       ("sharded 4 int32", {
                           "mesh": make_mesh((4,), ("model",),
                                             devices=["cpu"] * 4),
                           "wire_dtype": "int32", "prg_masks": True})]:
        sess = connect(spec, backend=name.split()[0], key=21, **opts)
        y = sess.matmul(a, b).numpy()
        assert y.shape == (1, v)
        np.testing.assert_allclose(y, a @ b, atol=0.05)
        outs[name] = y
    want = np.asarray(jconnect(JSpec(s=2, t=2, z=2)).matmul(
        a, b, key=jax.random.PRNGKey(21)))
    for name, y in outs.items():
        np.testing.assert_array_equal(y, want, err_msg=name)


def test_secure_matmul_shim_equivalence():
    """The float facade equals encode → ``AGECMPCProtocol.run`` → decode
    bit for bit (same key, one block), on the local and sharded paths."""
    rng = np.random.default_rng(12)
    a = rng.standard_normal((8, 8)).astype(np.float32)
    b = rng.standard_normal((8, 8)).astype(np.float32)
    proto = AGECMPCProtocol(s=2, t=2, z=2, m=8)
    f = proto.field
    legacy = f.decode(proto.run(f.encode(a), f.encode(b), 0, device="cpu"),
                      products=2).to(torch.float32)
    shim = secure_matmul(a, b, s=2, t=2, z=2, device="cpu")
    assert shim.dtype == torch.float32
    np.testing.assert_array_equal(shim.numpy(), legacy.numpy())
    mesh = make_mesh((8,), ("model",), devices=["cpu"] * 8)
    sharded = secure_matmul(a, b, s=2, t=2, z=2, mesh=mesh)
    np.testing.assert_array_equal(sharded.numpy(), legacy.numpy())
    assert float(np.abs(sharded.numpy() - a.T @ b).max()) < 0.05
    direct = connect(MPCSpec(s=2, t=2, z=2, m=8), device="cpu").matmul(
        a.T, b, key=0)
    np.testing.assert_array_equal(shim.numpy(), direct.numpy())


def test_sharded_dispatch_scale_coarsens_tiling():
    """ceil(N / axis) waves scale the dispatch term: on a one-device mesh
    the sharded session tiles no finer than the local one."""
    mesh = make_mesh((1,), ("model",), devices=["cpu"])
    spec = MPCSpec(s=2, t=2, z=2)                       # N = 17
    cm = CostModel(dispatch=5e5)
    sh = connect(spec, backend="sharded", mesh=mesh, cost=cm)
    assert sh.backend.dispatch_scale(spec) == float(spec.n_workers)
    assert ShardedBackend(mesh=make_mesh(
        (4,), ("model",), devices=["cpu"] * 4)).dispatch_scale(spec) == 5.0
    lo = connect(spec, cost=cm, device="cpu")
    assert lo.backend.dispatch_scale(spec) == 1.0
    p = spec.field.p
    rng = np.random.default_rng(29)
    a, b = rng.integers(0, p, (8, 64)), rng.integers(0, p, (8, 64)).T
    want = np.array((a.astype(object) @ b.astype(object)) % p, np.int64)
    np.testing.assert_array_equal(sh.matmul(a, b, encoded=True).numpy(), want)
    np.testing.assert_array_equal(lo.matmul(a, b, encoded=True).numpy(), want)
    assert sh.stats["blocks"] <= lo.stats["blocks"]


def test_sharded_backend_rejects_verification():
    spec = MPCSpec(s=2, t=2, z=2, m=4, adversaries=1)
    with pytest.raises(ValueError, match="sharded"):
        connect(spec, backend="sharded", mesh=None)
    with pytest.raises(ValueError, match="sharded"):
        connect(MPCSpec(s=2, t=2, z=2, m=4), backend="sharded",
                mesh=None, injector=FaultInjector())
    with pytest.raises(ValueError, match="requires mesh"):
        connect(MPCSpec(s=2, t=2, z=2, m=4), backend="sharded", mesh=None)


def test_sharded_backend_isolates_a_block_below_quorum():
    """A block whose survivor mask is below t²+z becomes a BlockFailure in
    its slot, as on the local backend; the other blocks are served."""
    from repro_torch.mpc.api import BlockFailure, BlockOp

    mesh = make_mesh((2,), ("model",), devices=["cpu"] * 2)
    spec = MPCSpec(s=2, t=2, z=2, m=4)
    proto = spec.protocol(4)
    p = spec.field.p
    rng = np.random.default_rng(4)
    a, b = (torch.from_numpy(rng.integers(0, p, (4, 4))) for _ in range(2))
    alive = np.zeros(spec.n_workers, bool)
    alive[:5] = True                                    # quorum is 6
    ops = [BlockOp(proto=proto, a=a, b=b, key=1, survivors=alive),
           BlockOp(proto=proto, a=a, b=b, key=2, survivors=None)]
    bad, good = ShardedBackend(mesh=mesh).run_blocks(ops)
    assert isinstance(bad, BlockFailure) and "threshold" in str(bad)
    want = np.array((a.numpy().astype(object).T @ b.numpy().astype(object))
                    % p, np.int64)
    np.testing.assert_array_equal(good.numpy(), want)
