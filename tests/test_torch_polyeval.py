"""``polyeval``'s operand forms held against the JAX kernel and reference.

The port's ``polyeval`` reads the rows of T in three forms: one tensor, the
rows of a tensor picked by a device index (decode), and two tensors stacked
(the exchange: H-points, then the mask).  On the CPU the wrapper runs its
plain version; for every form it must equal, integer for integer, JAX's
Pallas kernel (``interpret=True``, where the kernel takes K: K within
``acc_window(p)``) and ``ref.polyeval_ref`` on the stacked operand.  The
CUDA kernel is held against the plain version on the card in
``tests/test_torch_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.polyeval import polyeval as j_polyeval
from repro.mpc.field import P_DEFAULT, P_MERSENNE31, acc_window
from repro_torch.kernels.polyeval import polyeval, stacked_terms
from repro_torch.mpc import MPCSpec
from repro_torch.mpc.errors import ShapeContractError


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64))


# (form, p, N, K, R or K2, C): "rows" takes K of R rows through an index;
# "pair" stacks [K, C] on [K2, C]; odd C, K past M31's window of 2, and the
# main path's exchange (17 + 2) and decode (6 of 17) shapes, cut in width
CASES = [
    ("rows", P_DEFAULT, 4, 6, 17, 1001),
    ("rows", P_DEFAULT, 17, 19, 25, 64),
    ("rows", P_MERSENNE31, 4, 6, 17, 333),
    ("rows", P_MERSENNE31, 9, 40, 12, 77),
    ("pair", P_DEFAULT, 17, 17, 2, 1001),
    ("pair", P_DEFAULT, 5, 1, 1, 3),
    ("pair", P_MERSENNE31, 17, 17, 2, 333),
    ("pair", P_MERSENNE31, 40, 30, 9, 65),
]


def _operands(form, p, n, k, other, c, rng, fill=None):
    """(vand, terms, rows, stacked) as numpy, for ``form``."""
    def draw(*shape):
        if fill is not None:
            return np.full(shape, fill, np.int64)
        return rng.integers(0, p, shape)

    if form == "rows":
        src = draw(other, c)
        idx = np.sort(rng.choice(other, k, replace=k > other))
        vand = draw(n, k)
        return vand, src, idx, src[idx]
    top, bottom = draw(k, c), draw(other, c)
    vand = draw(n, k + other)
    return vand, (top, bottom), None, np.concatenate([top, bottom])


def _call(vand, terms, idx, p):
    ts = T(terms) if isinstance(terms, np.ndarray) else tuple(map(T, terms))
    return polyeval(T(vand), ts, p=p,
                    rows=None if idx is None else T(idx)).numpy()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_polyeval_forms_equal_jax(case):
    form, p, n, k, other, c = case
    rng = np.random.default_rng(n * 100 + k + c)
    vand, terms, idx, stacked = _operands(form, p, n, k, other, c, rng)
    got = _call(vand, terms, idx, p)
    np.testing.assert_array_equal(got, np.asarray(ref.polyeval_ref(
        jnp.asarray(vand), jnp.asarray(stacked), p=p)))
    if vand.shape[1] <= acc_window(p):    # the Pallas kernel's one window
        np.testing.assert_array_equal(got, np.asarray(j_polyeval(
            jnp.asarray(vand), jnp.asarray(stacked), p=p, interpret=True)))


@pytest.mark.parametrize("p", [P_DEFAULT, P_MERSENNE31])
@pytest.mark.parametrize("form", ["rows", "pair"])
def test_polyeval_forms_worst_case_corner(form, p):
    """Every element p−1 at K = 19 (the exchange's 17 + 2)."""
    rng = np.random.default_rng(19)
    k, other = (19, 25) if form == "rows" else (17, 2)
    vand, terms, idx, stacked = _operands(form, p, 17, k, other, 515, rng,
                                          fill=p - 1)
    got = _call(vand, terms, idx, p)
    np.testing.assert_array_equal(got, np.full((17, 515),
                                               pow(p - 1, 2, p) * 19 % p))
    np.testing.assert_array_equal(got, np.asarray(ref.polyeval_ref(
        jnp.asarray(vand), jnp.asarray(stacked), p=p)))


def test_polyeval_reads_strided_rows():
    """Rows with a row stride wider than C (a column slice) are read in
    place, in every form."""
    rng = np.random.default_rng(4)
    big = T(rng.integers(0, P_DEFAULT, (8, 40)))
    view = big[:, 3:36]
    assert view.stride() == (40, 1) and not view.is_contiguous()
    vand = T(rng.integers(0, P_DEFAULT, (3, 8)))
    want = polyeval(vand, view.contiguous(), p=P_DEFAULT)
    assert torch.equal(polyeval(vand, view, p=P_DEFAULT), want)
    assert torch.equal(polyeval(vand, (view[:5], view[5:]), p=P_DEFAULT), want)
    idx = torch.arange(8)
    assert torch.equal(polyeval(vand, view, p=P_DEFAULT, rows=idx), want)
    assert torch.equal(stacked_terms((view[:5], view[5:])), view)


def test_polyeval_refuses_malformed_forms():
    a = torch.zeros((4, 6), dtype=torch.int64)
    with pytest.raises(ShapeContractError):
        polyeval(a, (a[:3], torch.zeros((3, 5), dtype=torch.int64)),
                 p=P_DEFAULT)
    with pytest.raises(ShapeContractError):
        polyeval(a, (a, a, a), p=P_DEFAULT)
    with pytest.raises(ValueError, match="one term tensor"):
        polyeval(a, (a[:3], a[:3]), p=P_DEFAULT, rows=torch.arange(6))
    with pytest.raises(TypeError, match="int64 vector"):
        polyeval(a, a, p=P_DEFAULT, rows=torch.arange(6, dtype=torch.int32))
    with pytest.raises(ShapeContractError, match="row indices"):
        polyeval(a, a, p=P_DEFAULT, rows=torch.arange(5))
    with pytest.raises(ValueError, match="contiguous vand"):
        polyeval(torch.zeros((6, 4), dtype=torch.int64).T,
                 torch.zeros((6, 3), dtype=torch.int64), p=P_DEFAULT)


@pytest.mark.parametrize("z", [1, 2, 3])
def test_exchange_table_is_g_mix_beside_the_mask_table(z):
    """The plan's fused exchange table is ``[g_mix_t | vand_g_secret]``,
    ``[N, N + z]``, and the exchange stage equals the two products folded
    apart."""
    spec = MPCSpec(s=2, t=2, z=z)
    plan = spec.plan(8)
    tab = plan.tables("cpu")
    n = plan.n_workers
    assert tab["exchange"].shape == (n, n + z)
    assert torch.equal(tab["exchange"],
                       torch.cat([tab["g_mix_t"], tab["vand_g_secret"]], 1))
    np.testing.assert_array_equal(
        tab["exchange"].numpy(),
        np.concatenate([plan.g_mix.T, plan.vand_g_secret], axis=1))
    p, mt = plan.p, plan.m // plan.t
    rng = np.random.default_rng(z)
    h = T(rng.integers(0, p, (n, mt, mt)))
    mask = T(rng.integers(0, p, (z, mt, mt)))
    got = plan.stages("cpu").exchange(h, None, mask_sum=mask)
    want = (polyeval(tab["g_mix_t"], h.reshape(n, -1), p=p)
            + polyeval(tab["vand_g_secret"], mask.reshape(z, -1), p=p)) % p
    assert torch.equal(got.reshape(n, -1), want)


# (form, p, B, N, K, R or K2, C): the batched forms one launch serves for a
# wave of B lanes: lanes of one tensor, lanes of a pair, shared rows of
# each lane, and per-lane rows into one flattened tensor
BATCHED = [
    ("lanes", P_DEFAULT, 3, 17, 6, 0, 1001),
    ("lanes", P_MERSENNE31, 8, 17, 6, 0, 64),
    ("pair", P_DEFAULT, 4, 17, 17, 2, 333),
    ("pair", P_MERSENNE31, 2, 17, 17, 2, 65),
    ("rows", P_DEFAULT, 5, 4, 6, 17, 77),
    ("rows", P_MERSENNE31, 2, 9, 40, 12, 33),
    ("lane_rows", P_DEFAULT, 3, 4, 6, 17, 101),
    ("lane_rows", P_MERSENNE31, 4, 4, 6, 17, 64),
]


@pytest.mark.parametrize("case", BATCHED, ids=str)
def test_polyeval_batched_forms_equal_jax_per_lane(case):
    """Every lane of a batched call equals JAX's ``polyeval_ref`` (and the
    Pallas kernel, where K fits its window) on that lane's stacked rows."""
    form, p, lanes, n, k, other, c = case
    rng = np.random.default_rng(lanes * 1000 + n + k + c)
    if form == "lanes":
        terms = rng.integers(0, p, (lanes, k, c))
        vand = rng.integers(0, p, (n, k))
        got = polyeval(T(vand), T(terms), p=p)
        stacked = list(terms)
    elif form == "pair":
        top = rng.integers(0, p, (lanes, k, c))
        bottom = rng.integers(0, p, (lanes, other, c))
        vand = rng.integers(0, p, (n, k + other))
        got = polyeval(T(vand), (T(top), T(bottom)), p=p)
        stacked = [np.concatenate([x, y]) for x, y in zip(top, bottom,
                                                          strict=True)]
    elif form == "rows":
        src = rng.integers(0, p, (lanes, other, c))
        idx = np.sort(rng.choice(other, k, replace=k > other))
        vand = rng.integers(0, p, (n, k))
        got = polyeval(T(vand), T(src), p=p, rows=T(idx))
        stacked = [x[idx] for x in src]
    else:
        src = rng.integers(0, p, (lanes * other, c))
        idx = np.stack([np.sort(rng.choice(other, k, replace=False)) + other * b
                        for b in rng.permutation(lanes)])
        vand = rng.integers(0, p, (n, k))
        got = polyeval(T(vand), T(src), p=p, rows=T(idx))
        stacked = [src[i] for i in idx]
    assert got.shape == (lanes, n, c)
    for lane, want_rows in enumerate(stacked):
        want = np.asarray(ref.polyeval_ref(jnp.asarray(vand),
                                           jnp.asarray(want_rows), p=p))
        np.testing.assert_array_equal(got[lane].numpy(), want)
        if vand.shape[1] <= acc_window(p):
            np.testing.assert_array_equal(got[lane].numpy(), np.asarray(
                j_polyeval(jnp.asarray(vand), jnp.asarray(want_rows), p=p,
                           interpret=True)))


def test_polyeval_refuses_malformed_batched_forms():
    a = torch.zeros((4, 6), dtype=torch.int64)
    lanes = torch.zeros((2, 6, 5), dtype=torch.int64)
    with pytest.raises(ShapeContractError):
        polyeval(a, (lanes, torch.zeros((3, 1, 5), dtype=torch.int64)),
                 p=P_DEFAULT)
    with pytest.raises(ShapeContractError):
        polyeval(a, (lanes, torch.zeros((1, 5), dtype=torch.int64)),
                 p=P_DEFAULT)
    with pytest.raises(ShapeContractError, match="per-lane rows"):
        polyeval(a, lanes, p=P_DEFAULT, rows=torch.zeros((2, 6),
                                                         dtype=torch.int64))
    with pytest.raises(TypeError, match="matrix"):
        polyeval(a, lanes, p=P_DEFAULT,
                 rows=torch.zeros((2, 3, 6), dtype=torch.int64))
