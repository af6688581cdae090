"""The port's ``kernels.ref`` oracles and ``kernels.ops`` dispatchers held
against the JAX package's on the same numpy inputs.

The mod-p twins are integers and held equal, for both primes and the
all-(p-1) corner.  Attention and WKV-6 are held at 2e-5 absolute and
relative in fp32 (the sums run in another order; the port's WKV sums its
bonus scalar in fp64).  The dispatchers are held both ways: ``use_kernel``
(the wrappers, which take their plain versions on these CPU tensors) and
the oracle, each against JAX's oracle path (``use_pallas=False``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.mpc.field import P_DEFAULT, P_MERSENNE31
from repro_torch.kernels import launch_counts, ops, ref, reset_launch_counts

PRIMES = [P_DEFAULT, P_MERSENNE31]
FLOAT = dict(atol=2e-5, rtol=2e-5)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def field(seed, p, *shape, corner=False):
    if corner:
        return np.full(shape, p - 1, dtype=np.int64)
    return np.random.default_rng(seed).integers(0, p, shape, dtype=np.int64)


def floats(seed, *shape, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) + shift).astype(
        np.float32)


# ------------------------------------------------------------------ mod p
@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("m,k,n,corner", [(5, 7, 3, False), (17, 64, 33, False),
                                          (4, 300, 2, True), (1, 1, 1, False)])
def test_modmatmul_and_polyeval_refs_equal_jax(p, m, k, n, corner):
    a, b = field(m, p, m, k, corner=corner), field(n, p, k, n, corner=corner)
    want = np.asarray(j_ref.modmatmul_ref(jnp.asarray(a), jnp.asarray(b), p=p))
    np.testing.assert_array_equal(N(ref.modmatmul_ref(T(a), T(b), p=p)), want)
    np.testing.assert_array_equal(N(ref.polyeval_ref(T(a), T(b), p=p)), want)
    np.testing.assert_array_equal(
        np.asarray(j_ref.polyeval_ref(jnp.asarray(a), jnp.asarray(b), p=p)), want)


@pytest.mark.parametrize("p", PRIMES)
def test_modmatmul_batched_ref_equals_jax(p):
    a, b = field(1, p, 3, 6, 40), field(2, p, 3, 40, 5)
    want = np.asarray(j_ref.modmatmul_batched_ref(jnp.asarray(a),
                                                  jnp.asarray(b), p=p))
    got = ref.modmatmul_batched_ref(T(a), T(b), p=p)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(N(got), want)


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_mod_matmul_and_poly_eval_dispatch_equal_jax(p, use_kernel):
    a, b = field(3, p, 9, 20), field(4, p, 20, 11)
    vand, terms = field(5, p, 17, 6), field(6, p, 6, 50)
    reset_launch_counts()
    np.testing.assert_array_equal(
        N(ops.mod_matmul(T(a), T(b), p=p, use_kernel=use_kernel)),
        np.asarray(j_ops.mod_matmul(jnp.asarray(a), jnp.asarray(b), p=p)))
    np.testing.assert_array_equal(
        N(ops.poly_eval(T(vand), T(terms), p=p, use_kernel=use_kernel)),
        np.asarray(j_ops.poly_eval(jnp.asarray(vand), jnp.asarray(terms), p=p)))
    assert not any(launch_counts().values())            # CPU: plain versions


# ------------------------------------------------------------------ WKV-6
def wkv_inputs(seed, b=2, t=21, h=3, d=8):
    r, k, v = (floats(seed + i, b, t, h, d) * 0.5 for i in range(3))
    w = floats(seed + 3, b, t, h, d, shift=-1.0)
    u = floats(seed + 4, h, d) * 0.5
    return r, k, v, w, u


def test_rwkv6_refs_equal_jax():
    ins = wkv_inputs(10)
    j_ins = [jnp.asarray(x) for x in ins]
    t_ins = [T(x) for x in ins]
    want = np.asarray(j_ref.rwkv6_ref(*j_ins))
    np.testing.assert_allclose(N(ref.rwkv6_ref(*t_ins)), want, **FLOAT)
    out, state = ref.rwkv6_scan_with_state(*t_ins)
    j_out, j_state = j_ref.rwkv6_scan_with_state(*j_ins)
    np.testing.assert_allclose(N(out), N(j_out), **FLOAT)
    np.testing.assert_allclose(N(state), N(j_state), **FLOAT)
    s0 = floats(11, 2, 3, 8, 8)
    out, state = ref.rwkv6_scan_with_state(*t_ins, T(s0))
    j_out, j_state = j_ref.rwkv6_scan_with_state(*j_ins, jnp.asarray(s0))
    np.testing.assert_allclose(N(out), N(j_out), **FLOAT)
    np.testing.assert_allclose(N(state), N(j_state), **FLOAT)


@pytest.mark.parametrize("chunk", [4, 7, 32])
def test_rwkv6_chunked_equals_jax(chunk):
    ins = wkv_inputs(20 + chunk)
    out, state = ref.rwkv6_chunked(*map(T, ins), chunk=chunk, return_state=True)
    j_out, j_state = j_ref.rwkv6_chunked(*map(jnp.asarray, ins), chunk=chunk,
                                         return_state=True)
    np.testing.assert_allclose(N(out), N(j_out), **FLOAT)
    np.testing.assert_allclose(N(state), N(j_state), **FLOAT)
    np.testing.assert_allclose(N(ref.rwkv6_chunked(*map(T, ins), chunk=chunk)),
                               N(j_out), **FLOAT)
    with pytest.raises(ValueError, match="chunk"):
        ref.rwkv6_chunked(*map(T, ins), chunk=0)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_wkv6_dispatch_equals_jax(use_kernel):
    ins = wkv_inputs(30, d=64)
    got = ops.wkv6(*map(T, ins), use_kernel=use_kernel)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(N(got), np.asarray(j_ops.wkv6(*map(jnp.asarray,
                                                                  ins))),
                               **FLOAT)


# -------------------------------------------------------------- attention
# (B, T, S, Hq, Hkv, D, causal): T == S; T < S (the causal mask aligned
# bottom-right); GQA; non-causal cross shapes
ATTN = [(2, 9, 9, 4, 1, 32, True), (1, 5, 12, 4, 2, 16, True),
        (2, 7, 7, 6, 3, 8, False), (1, 4, 15, 2, 2, 32, False),
        (1, 1, 1, 2, 1, 8, True)]


@pytest.mark.parametrize("case", ATTN, ids=str)
def test_flash_attention_ref_equals_jax(case):
    b, t, s, hq, hkv, d, causal = case
    q, k, v = floats(1, b, t, hq, d), floats(2, b, s, hkv, d), floats(3, b, s,
                                                                      hkv, d)
    got = ref.flash_attention_ref(T(q), T(k), T(v), causal=causal)
    want = j_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(N(got), N(want), **FLOAT)
    scaled = ref.flash_attention_ref(T(q), T(k), T(v), causal=causal, scale=0.3)
    j_scaled = j_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal, scale=0.3)
    np.testing.assert_allclose(N(scaled), N(j_scaled), **FLOAT)


@pytest.mark.parametrize("case", [c for c in ATTN if c[1] == c[2] or not c[-1]],
                         ids=str)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_attention_dispatch_equals_jax(case, use_kernel):
    """Where T == S or the mask is off, the kernel's top-left alignment and
    the oracle's bottom-right one agree."""
    b, t, s, hq, hkv, d, causal = case
    q, k, v = floats(4, b, t, hq, d), floats(5, b, s, hkv, d), floats(6, b, s,
                                                                      hkv, d)
    got = ops.attention(T(q), T(k), T(v), causal=causal, use_kernel=use_kernel)
    want = j_ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal)
    np.testing.assert_allclose(N(got), N(want), **FLOAT)


def test_kernel_and_oracle_differ_only_in_the_causal_alignment():
    q, k, v = floats(7, 1, 4, 2, 8), floats(8, 1, 10, 2, 8), floats(9, 1, 10, 2, 8)
    kern = ops.attention(T(q), T(k), T(v), use_kernel=True)
    oracle = ops.attention(T(q), T(k), T(v))
    assert not np.allclose(N(kern), N(oracle), **FLOAT)
    from repro_torch.kernels.flash_attention import flash_attention_plain

    np.testing.assert_allclose(
        N(flash_attention_plain(T(q), T(k), T(v), q_offset=6)), N(oracle),
        **FLOAT)
