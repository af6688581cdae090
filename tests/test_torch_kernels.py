"""The port's kernel modules held against the JAX Pallas kernels.

On the CPU each wrapper runs its plain version; those must equal the
Pallas kernels run as ``tests/test_kernels.py`` runs them
(``interpret=True``) and ``repro.kernels.ref``, integer for integer.  The
CUDA kernels themselves are held against the plain versions on the card in
``tests/test_torch_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.modmatmul import modmatmul as j_modmatmul
from repro.kernels.modmatmul import modmatmul_batched as j_modmatmul_batched
from repro.kernels.polyeval import polyeval as j_polyeval
from repro.mpc.field import P_DEFAULT, P_MERSENNE31, Field
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.modmatmul import (
    MAX_GRID_Z,
    MIN_SPLIT_K,
    TILE_K,
    k_splits,
    modmatmul,
    modmatmul_batched,
)
from repro_torch.kernels.polyeval import polyeval
from repro_torch.kernels.ring_fold import ring_fold
from repro_torch.kernels.rwkv6 import rwkv6, rwkv6_bwd
from repro_torch.kernels.selective_scan import selective_scan, selective_scan_bwd
from repro_torch.mpc.errors import ShapeContractError

PRIMES = [P_DEFAULT, P_MERSENNE31]

# tests/test_kernels.py's modmatmul sweep: ragged, degenerate, multi K-fold
MM_SHAPES = [
    (8, 8, 8, 8, 8, 8),
    (16, 300, 12, 8, 8, 128),
    (33, 65, 17, 16, 16, 32),
    (128, 512, 128, 128, 128, 512),
    (1, 7, 1, 8, 8, 8),
    (64, 1024, 64, 32, 32, 512),
]


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64))


# --------------------------------------------------------------- modmatmul
@pytest.mark.parametrize("m,k,n,bm,bn,bk", MM_SHAPES)
def test_modmatmul_equals_pallas_default_prime(m, k, n, bm, bn, bk):
    rng = np.random.default_rng(m * 1000 + k + n)
    a = rng.integers(0, P_DEFAULT, (m, k))
    b = rng.integers(0, P_DEFAULT, (k, n))
    want = np.asarray(j_modmatmul(jnp.asarray(a), jnp.asarray(b), p=P_DEFAULT,
                                  bm=bm, bn=bn, bk=bk, interpret=True))
    np.testing.assert_array_equal(modmatmul(T(a), T(b), p=P_DEFAULT).numpy(),
                                  want)


@pytest.mark.parametrize("m,k,n", [s[:3] for s in MM_SHAPES])
def test_modmatmul_equals_ref_m31(m, k, n):
    rng = np.random.default_rng(m + 7 * k + n)
    a = rng.integers(0, P_MERSENNE31, (m, k))
    b = rng.integers(0, P_MERSENNE31, (k, n))
    want = np.asarray(ref.modmatmul_ref(jnp.asarray(a), jnp.asarray(b),
                                        p=P_MERSENNE31))
    np.testing.assert_array_equal(
        modmatmul(T(a), T(b), p=P_MERSENNE31).numpy(), want)


@pytest.mark.parametrize("w,m,k,n", [(3, 16, 40, 8), (17, 8, 8, 8),
                                     (2, 33, 65, 17), (1, 1, 7, 1)])
def test_modmatmul_batched_equals_pallas(w, m, k, n):
    rng = np.random.default_rng(w + m + k + n)
    a = rng.integers(0, P_DEFAULT, (w, m, k))
    b = rng.integers(0, P_DEFAULT, (w, k, n))
    want = np.asarray(j_modmatmul_batched(jnp.asarray(a), jnp.asarray(b),
                                          p=P_DEFAULT, bm=16, bn=16, bk=32,
                                          interpret=True))
    np.testing.assert_array_equal(
        modmatmul_batched(T(a), T(b), p=P_DEFAULT).numpy(), want)
    want31 = np.asarray(ref.modmatmul_batched_ref(
        jnp.asarray(a % P_MERSENNE31), jnp.asarray(b % P_MERSENNE31),
        p=P_MERSENNE31))
    np.testing.assert_array_equal(
        modmatmul_batched(T(a % P_MERSENNE31), T(b % P_MERSENNE31),
                          p=P_MERSENNE31).numpy(), want31)


@pytest.mark.parametrize("p", PRIMES)
def test_modmatmul_worst_case_corner(p):
    """All entries p−1 (the corner tests/test_analysis.py certifies)."""
    m = k = n = 64
    a = np.full((m, k), p - 1, np.int64)
    b = np.full((k, n), p - 1, np.int64)
    want = np.full((m, n), (pow(p - 1, 2, p) * k) % p)
    np.testing.assert_array_equal(modmatmul(T(a), T(b), p=p).numpy(), want)
    np.testing.assert_array_equal(
        modmatmul_batched(T(a[None]), T(b[None]), p=p).numpy()[0], want)
    if p == P_DEFAULT:
        got = np.asarray(j_modmatmul(jnp.asarray(a), jnp.asarray(b), p=p,
                                     bk=512))
        np.testing.assert_array_equal(got, want)


def test_wrappers_check_operands():
    a = torch.zeros((4, 6), dtype=torch.int64)
    with pytest.raises(ShapeContractError):
        modmatmul(a, torch.zeros((5, 3), dtype=torch.int64), p=P_DEFAULT)
    with pytest.raises(TypeError, match="int64"):
        modmatmul(a.to(torch.int32), a.T.contiguous(), p=P_DEFAULT)
    with pytest.raises(ValueError, match="contiguous"):
        modmatmul(a.T, a.T.contiguous().T, p=P_DEFAULT)
    with pytest.raises(ShapeContractError):
        modmatmul_batched(a[None], torch.zeros((2, 6, 3), dtype=torch.int64),
                          p=P_DEFAULT)
    with pytest.raises(ShapeContractError):
        polyeval(a, torch.zeros((5, 3), dtype=torch.int64), p=P_DEFAULT)
    with pytest.raises(ValueError, match="contiguous"):
        polyeval(a, torch.zeros((3, 6), dtype=torch.int64).T, p=P_DEFAULT)


@pytest.mark.parametrize("w,m,k,n", [(17, 1024, 1024, 1024), (1, 17, 2**20, 1),
                                     (4, 256, 3000, 64), (1, 1, 7, 1),
                                     (1, 5, 0, 3), (40000, 8, 4096, 8)])
def test_k_splits_cover_k_and_fill_the_card(w, m, k, n):
    """Split K only where the output tiles leave SMs idle; the chunks are
    whole shared-memory passes that cover K, within the grid's z limit."""
    splits, chunk = k_splits(w, m, k, n, 132)
    tiles = w * -(-m // 64) * -(-n // 64)
    assert splits * chunk >= k and (splits - 1) * chunk < max(k, 1)
    assert w * splits <= MAX_GRID_Z
    if splits == 1:
        assert tiles >= 132 or k < 2 * MIN_SPLIT_K or w * 2 > MAX_GRID_Z
    else:
        assert chunk % TILE_K == 0 and chunk >= MIN_SPLIT_K
        assert tiles * splits <= 2 * 132 + tiles
    if (w, m, k, n) == (1, 17, 2**20, 1):   # the MAC tags' product
        assert splits > 132


def test_cpu_tensors_launch_nothing():
    reset_launch_counts()
    a = torch.ones((3, 4, 4), dtype=torch.int64)
    modmatmul_batched(a, a, p=P_DEFAULT)
    modmatmul(a[0], a[0], p=P_DEFAULT)
    polyeval(a[0], a[0], p=P_DEFAULT)
    x = torch.ones((1, 4, 2, 32))
    flash_attention(x, x[:, :, :1], x[:, :, :1])
    y = torch.ones((1, 3, 2, 64))
    rwkv6(y, y, y, y, torch.ones((2, 64)))
    ring_fold(a[0].to(torch.int32), a[0].to(torch.int32), p=P_DEFAULT)
    z = torch.ones((1, 3, 4))
    selective_scan(z, z, -torch.ones((4, 8)), z[..., :1].expand(1, 3, 8),
                   z[..., :1].expand(1, 3, 8))
    rwkv6_bwd(y, y, y, y, torch.ones((2, 64)), y)
    selective_scan_bwd(z, z, -torch.ones((4, 8)), z[..., :1].expand(1, 3, 8),
                       z[..., :1].expand(1, 3, 8), z)
    assert launch_counts() == {"modmatmul_batched": 0, "modmatmul": 0,
                               "polyeval": 0, "flash_attention": 0,
                               "flash_attention_bwd": 0, "rwkv6": 0,
                               "rwkv6_bwd": 0, "ring_fold": 0,
                               "selective_scan": 0, "selective_scan_bwd": 0}


# ---------------------------------------------------------------- polyeval
@pytest.mark.parametrize("n,k,c", [(17, 6, 16), (5, 30, 100), (64, 12, 513),
                                   (17, 17, 64), (4, 6, 50), (17, 2, 33)])
def test_polyeval_equals_pallas(n, k, c):
    rng = np.random.default_rng(n + k + c)
    vand = rng.integers(0, P_DEFAULT, (n, k))
    terms = rng.integers(0, P_DEFAULT, (k, c))
    got = polyeval(T(vand), T(terms), p=P_DEFAULT).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_polyeval(
        jnp.asarray(vand), jnp.asarray(terms), p=P_DEFAULT, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(ref.polyeval_ref(
        jnp.asarray(vand), jnp.asarray(terms), p=P_DEFAULT)))


@pytest.mark.parametrize("n,k,c", [(17, 6, 16), (5, 30, 100), (17, 17, 64),
                                   (3, 2, 9)])
def test_polyeval_m31_past_the_window(n, k, c):
    """M31's window is 2: K past it is refused by the Pallas kernel and
    served here; held against ref.polyeval_ref and Field.matmul."""
    rng = np.random.default_rng(3 * n + k + c)
    vand = rng.integers(0, P_MERSENNE31, (n, k))
    terms = rng.integers(0, P_MERSENNE31, (k, c))
    got = polyeval(T(vand), T(terms), p=P_MERSENNE31).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.polyeval_ref(
        jnp.asarray(vand), jnp.asarray(terms), p=P_MERSENNE31)))
    np.testing.assert_array_equal(
        got, np.asarray(Field(P_MERSENNE31).matmul(vand, terms)))


@pytest.mark.parametrize("p", PRIMES)
def test_polyeval_worst_case_corner(p):
    vand = np.full((17, 9), p - 1, np.int64)
    terms = np.full((9, 40), p - 1, np.int64)
    want = np.full((17, 40), (pow(p - 1, 2, p) * 9) % p)
    np.testing.assert_array_equal(polyeval(T(vand), T(terms), p=p).numpy(),
                                  want)


# ------------------------------------------------------ the skinny instance
@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("w,m,k,n", [(1, 17, 4096, 1), (1, 17, 4093, 1),
                                     (3, 17, 1000, 1), (2, 5, 777, 2),
                                     (1, 40, 300, 4), (1, 1, 1, 1)])
def test_skinny_shapes_equal_pallas_modmatmul(p, w, m, k, n):
    """The skinny instance's shapes (the tags' N = 1, ragged K, a wave of
    lanes, N up to 4): the plain version the CPU runs equals JAX's
    ``modmatmul`` at W = 1 and ``modmatmul_batched`` per lane
    (``interpret=True``) and the object-dtype product."""
    from repro_torch.kernels.modmatmul import choose_instance, modmatmul_plain

    assert choose_instance(w, m, k, n) == "skinny"
    rng = np.random.default_rng(w * 10_000 + m * 100 + k + n)
    a = rng.integers(0, p, (w, m, k))
    b = rng.integers(0, p, (w, k, n))
    got = modmatmul_batched(T(a), T(b), p=p).numpy()
    np.testing.assert_array_equal(got, modmatmul_plain(T(a), T(b), p=p).numpy())
    for lane in range(w):
        want = np.array((a[lane].astype(object) @ b[lane].astype(object)) % p,
                        np.int64)
        np.testing.assert_array_equal(got[lane], want)
        if lane == 0 and p == P_DEFAULT:
            np.testing.assert_array_equal(got[0], np.asarray(j_modmatmul(
                jnp.asarray(a[0]), jnp.asarray(b[0]), p=p, bm=8, bn=8,
                bk=128, interpret=True)))
            np.testing.assert_array_equal(
                modmatmul(T(a[0]), T(b[0]), p=p).numpy(), got[0])
    if p == P_DEFAULT and w > 1:
        np.testing.assert_array_equal(got, np.asarray(j_modmatmul_batched(
            jnp.asarray(a), jnp.asarray(b), p=p, interpret=True)))


def test_skinny_grid_rules():
    from repro_torch.kernels.modmatmul import (
        SKINNY_ROWS,
        choose_instance,
        skinny_blocks,
        skinny_rows,
    )

    assert skinny_rows(17, 1) == 20 and skinny_rows(5, 1) == 8
    assert skinny_rows(100, 1) == 32 and skinny_rows(9, 2) == 16
    assert skinny_rows(3, 3) == 8 and skinny_rows(40, 4) == 8
    for n, rows in SKINNY_ROWS.items():
        assert all(r <= 32 // n for r in rows)
    # up to 6 blocks per SM over the grid, each thread taking >= 8 steps
    # of K: the tags' shape is capped by the steps, a wave of 8 lanes
    # shares the 6 per SM, a short K gets one block
    assert skinny_blocks(1, 17, 2**20, 1, 132) == 256
    assert skinny_blocks(8, 17, 2**20, 1, 132) == 99
    assert skinny_blocks(64, 17, 2**20, 1, 132) == 13
    assert skinny_blocks(1, 40, 2**20, 1, 132) == 256
    assert skinny_blocks(1, 17, 4096, 1, 132) == 1
    assert skinny_blocks(1, 17, 7, 1, 132) == 1
    assert choose_instance(1, 17, 2**20, 5) == "cuda_core"
    assert choose_instance(1, 17, 0, 1) == "cuda_core"
