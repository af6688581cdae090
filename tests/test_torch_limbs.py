"""The tensor-core modmatmul instance's integer schedule and its walk over
the output tiles, and the kernel choosers, on the CPU.

``modmatmul_tc_emulation`` repeats ``csrc/modmatmul_tc.cu``'s arithmetic in
plain torch: unsigned 8-bit limbs, each diagonal ``D_d = Σ_{i+j=d} A_i B_j``
summed exactly over K-runs and checked below 2^31 (the kernel's s32
accumulator), then the Horner fold over the diagonals with two reductions,
``R <- mod_p(mod_p(D_6·2^32 + … + D_2)·2^16 + D_1·2^8 + D_0 + R)``.  It must
equal, integer for integer, JAX's Pallas ``modmatmul`` and
``modmatmul_batched`` run as ``tests/test_kernels.py`` runs them
(``interpret=True``; ``ref.modmatmul*_ref`` for M31, whose window the
Pallas kernel refuses past), and the port's barrett plain version.

``tc_tiles`` lists the persistent kernel's walk, which must store every
output tile once.  The choosers are pure functions of shapes, strides and
pointers, so they are asked here which kernel each product and each
attention call would get on the card.  The kernels themselves are held on the card in
``tests/test_torch_gpu.py``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.modmatmul import modmatmul as j_modmatmul
from repro.kernels.modmatmul import modmatmul_batched as j_modmatmul_batched
from repro.mpc.field import P_DEFAULT, P_MERSENNE31
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.analysis import overflow
from repro_torch.kernels import modmatmul as mm
from repro_torch.kernels.modmatmul import (
    K_RUN_MAX,
    choose_instance,
    modmatmul_plain,
    modmatmul_tc_emulation,
    tc_grid,
    tc_tiles,
)
from repro_torch.models import layers
from repro_torch.models import transformer as tr

PRIMES = [P_DEFAULT, P_MERSENNE31]
KERNEL_RUN = (K_RUN_MAX // 128) * 128   # modmatmul_tc.cu folds on 128-byte tiles


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64))


def _jax_batched(a, b, p):
    if p == P_DEFAULT:
        return np.asarray(j_modmatmul_batched(jnp.asarray(a), jnp.asarray(b), p=p,
                                              bm=16, bn=16, bk=32, interpret=True))
    return np.asarray(ref.modmatmul_batched_ref(jnp.asarray(a), jnp.asarray(b),
                                                p=p))


def _jax_single(a, b, p):
    if p == P_DEFAULT:
        return np.asarray(j_modmatmul(jnp.asarray(a), jnp.asarray(b), p=p,
                                      bm=16, bn=16, bk=32, interpret=True))
    return np.asarray(ref.modmatmul_ref(jnp.asarray(a), jnp.asarray(b), p=p))


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("w,m,k,n", [(3, 16, 40, 8), (2, 33, 65, 17),
                                     (1, 1, 7, 1), (2, 64, 300, 64),
                                     (17, 8, 8, 8)])
def test_emulation_equals_jax_batched(p, w, m, k, n):
    rng = np.random.default_rng(w * 100 + m + k + n)
    a = rng.integers(0, p, (w, m, k))
    b = rng.integers(0, p, (w, k, n))
    got = modmatmul_tc_emulation(T(a), T(b), p=p)
    np.testing.assert_array_equal(got.numpy(), _jax_batched(a, b, p))
    assert torch.equal(got, modmatmul_plain(T(a), T(b), p=p))


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("m,k,n", [(33, 65, 17), (128, 512, 128), (1, 7, 1),
                                   (64, 1024, 64)])
def test_emulation_equals_jax_single(p, m, k, n):
    rng = np.random.default_rng(m + 3 * k + n)
    a = rng.integers(0, p, (m, k))
    b = rng.integers(0, p, (k, n))
    got = modmatmul_tc_emulation(T(a), T(b), p=p)
    np.testing.assert_array_equal(got.numpy(), _jax_single(a, b, p))
    assert torch.equal(got, modmatmul_plain(T(a), T(b), p=p))


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("k", [8256, 8257, 20000])
def test_all_p_minus_1_corner_across_the_run_boundary(p, k):
    """All entries p-1 at K on both sides of one run and past two: the
    kernel's runs of 8192 and the bound's runs of 8256 give the closed form,
    as do JAX's reference and the plain version."""
    a = np.full((1, 2, k), p - 1, np.int64)
    b = np.full((1, k, 3), p - 1, np.int64)
    want = np.full((1, 2, 3), (pow(p - 1, 2, p) * k) % p)
    for run in (K_RUN_MAX, KERNEL_RUN):
        got = modmatmul_tc_emulation(T(a), T(b), p=p, run=run)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(ref.modmatmul_batched_ref(jnp.asarray(a), jnp.asarray(b), p=p)),
        want)
    np.testing.assert_array_equal(modmatmul_plain(T(a), T(b), p=p).numpy(), want)


def test_the_run_bound_is_tight(monkeypatch):
    """At the limb domain's corner (every limb 255: x = 2^32 - 1) a run of
    8256 keeps each diagonal below 2^31 and a run of 8257 does not.  The
    fields' own corners stay below even at 8257 (their top limb is at most
    127), so the constant is set by the 8-bit limbs, not by one prime.  The
    fold's first reduction is as late as it can be: after D_2 the high
    diagonals stay inside mod_p's domain at the corner, and taking D_1 in
    too leaves it, in the emulation and in the certificate alike."""
    assert 4 * 255**2 * K_RUN_MAX < 2**31 <= 4 * 255**2 * (K_RUN_MAX + 1)
    top = 2**32 - 1
    p = P_DEFAULT
    for k in (K_RUN_MAX, K_RUN_MAX + 1):
        a = torch.full((1, 1, k), top, dtype=torch.int64)
        b = torch.full((1, k, 1), top, dtype=torch.int64)
        want = (top * top * k) % p
        assert int(modmatmul_tc_emulation(a, b, p=p, run=K_RUN_MAX)) == want
        if k > K_RUN_MAX:
            with pytest.raises(OverflowError, match="2\\^31"):
                modmatmul_tc_emulation(a, b, p=p, run=k)
    for p in PRIMES:
        k = K_RUN_MAX + 1
        a = torch.full((1, 1, k), p - 1, dtype=torch.int64)
        b = torch.full((1, k, 1), p - 1, dtype=torch.int64)
        assert int(modmatmul_tc_emulation(a, b, p=p, run=k)) == (
            pow(p - 1, 2, p) * k) % p
    a = torch.full((1, 1, K_RUN_MAX), top, dtype=torch.int64)
    b = torch.full((1, K_RUN_MAX, 1), top, dtype=torch.int64)
    overflow.prove_tensor_core(P_DEFAULT, K_RUN_MAX)
    monkeypatch.setattr(mm, "TC_FOLD_LOW", mm.TC_FOLD_LOW - 1)
    with pytest.raises(OverflowError, match="high diagonals"):
        modmatmul_tc_emulation(a, b, p=P_DEFAULT)
    with pytest.raises(overflow.OverflowProofError, match="high diagonals"):
        overflow.prove_tensor_core(P_DEFAULT, K_RUN_MAX)


# ------------------------------------------------------------- the choosers
@pytest.mark.parametrize("shape,want", [
    ((17, 1024, 1024, 1024), "tensor_core"),   # the main path's worker product
    ((1, 17, 2**20, 1), "skinny"),             # the tags stage: N = 1
    ((3, 33, 65, 17), "cuda_core"),            # tiny, ragged
    ((2, 64, 7, 64), "tensor_core"),           # one full tile, short K
    ((4, 256, 3000, 63), "cuda_core"),         # N one short of a tile
    ((1, 64, 0, 64), "cuda_core"),             # empty K
    ((70000, 64, 64, 64), "cuda_core"),        # W past the grid's z limit
])
def test_modmatmul_chooser(shape, want):
    assert choose_instance(*shape) == want


# (W, M, N) for the tensor-core kernel's walk: the chooser's shapes, one
# tile (fewer units than SMs), an odd number of M-tiles (960 = 15 x 64),
# tile counts that are no multiple of 132, W = 5 and W = 34, ragged M and N
WALK_SHAPES = [(17, 1024, 1024), (1, 17, 1), (3, 33, 17), (2, 64, 64),
               (4, 256, 63), (1, 64, 64), (70000, 64, 64), (1, 960, 192),
               (3, 960, 1000), (5, 1024, 1024), (34, 1024, 1024),
               (5, 1000, 1100), (7, 100, 700)]


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("w,m,n", WALK_SHAPES)
def test_tc_walk_visits_every_tile_once(w, m, n, sms):
    """``tc_tiles``, the walk ``tc_grid``'s grid makes, stores every
    ``(worker, m-tile, n-tile)`` exactly once, from the CTAs the grid
    launches (two a cluster), and no CTA outside it."""
    clusters, m_pairs, n_tiles = tc_grid(w, m, n, sms)
    m_tiles = -(-m // 64)
    assert m_pairs == -(-m_tiles // 2) and n_tiles == -(-n // 64)
    assert clusters == max(1, min(w * m_pairs * n_tiles, sms // 2))
    seen = {}
    for cta, tile in tc_tiles(w, m, n, sms):
        assert 0 <= cta < 2 * clusters
        assert tile not in seen, (tile, cta, seen.get(tile))
        seen[tile] = cta
    assert len(seen) == w * m_tiles * n_tiles
    assert set(seen) == {(i, j, k) for i in range(w) for j in range(m_tiles)
                         for k in range(n_tiles)}


def test_main_path_products_take_the_tensor_cores():
    """The main path (lm_head [1,2048] x [2048,128256], MPCSpec(s=2, t=2,
    z=2)) runs 17 workers' [m/t, m/s] @ [m/s, m/t] blocks with m = 2048."""
    from repro_torch.mpc import MPCSpec
    from repro_torch.mpc.tiling import choose_block

    spec = MPCSpec(s=2, t=2, z=2)
    m = choose_block(spec.s, spec.t, 1, 2048, 128256)
    blk = m // spec.t
    assert choose_instance(spec.n_workers, blk, m // spec.s, blk) == "tensor_core"


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_chooser_takes_wgmma_for_aligned_bf16(d):
    q, k, v = _bf16(2, 40, 8, d), _bf16(2, 40, 2, d), _bf16(2, 40, 2, d)
    assert fa.choose_instance(q, k, v) == "wgmma"
    fused = _bf16(1, 40, 12, d)                 # views of one projection
    assert fa.choose_instance(*fused.split([8, 2, 2], dim=2)) == "wgmma"


def test_flash_chooser_takes_mma_sync_for_unaligned_bf16():
    fused = _bf16(1, 700, 48, 65)[..., 1:]     # chip_smoke's unaligned views
    q, k, v = fused.split([32, 8, 8], dim=2)
    assert fa.choose_instance(q, k, v) == "mma_sync"
    flat = _bf16(1 + 2 * 40 * 8 * 64)[1:]       # base off 16-byte alignment
    shifted = flat.view(2, 40, 8, 64)
    assert fa.choose_instance(shifted, shifted[:, :, :2], shifted[:, :, :2]) \
        == "mma_sync"


def test_flash_chooser_takes_cuda_cores_for_fp32():
    x = torch.zeros((1, 8, 4, 64))
    assert fa.choose_instance(x, x, x) == "cuda_core"


def test_llama_prefill_operands_take_wgmma():
    """The q, k, v that gqa_project makes for the served family: [B, T, H,
    64] bf16 with 128-byte rows (llama3.2-1b's head dim on the reduced
    widths)."""
    cfg = dataclasses.replace(reduced(get_config("llama3.2-1b")), head_dim=64)
    params = tr.init_params(cfg, 0, device="cpu").to(torch.bfloat16)
    lp = params.layers[0]
    x = params.embed[torch.arange(24)[None]]
    h = layers.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = layers.gqa_project(h, lp, cfg,
                                 positions=torch.arange(24)[None])
    assert q.dtype == torch.bfloat16 and q.shape[-1] == cfg.resolved_head_dim
    assert fa.choose_instance(q, k, v) == "wgmma"
