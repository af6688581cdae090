"""The port's Mamba block and selective scan held against the JAX package.

The scan's plain version (the CPU route of ``kernels.selective_scan``) is
held to JAX's ``_selective_scan_chunked`` within 1e-5 relative (fp32: the
same chunked associative scan, its tree in another order).  The blocks run
on reduced jamba-v0.1-52b's widths (``configs.reduced``: d 128, Di 256,
N 8, conv 4, chunk 16, fp32) with the weights of JAX's
``init_ssm_params`` carried across through numpy; inputs are drawn with
numpy from a seed.  Block outputs and states are held at 2e-5 absolute
and relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import ssm as j_ssm
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.selective_scan import (
    selective_scan,
    selective_scan_plain,
)
from repro_torch.models import ssm as t_ssm
from repro_torch.models.convert import tensor_from_numpy
from repro_torch.mpc.errors import InvariantError, ShapeContractError

LAYER = dict(atol=2e-5, rtol=2e-5)
SCAN_RTOL = 1e-5


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def block():
    cfg = j_reduced(j_get_config("jamba-v0.1-52b"))
    jp = j_ssm.init_ssm_params(jax.random.PRNGKey(1), cfg, jnp.float32)
    tp = t_ssm.Mamba({k: tensor_from_numpy(np.asarray(v), "cpu")
                      for k, v in jp.items()})
    return cfg, jp, tp


def scan_operands(seed, b, t, di, n, dt_shift=-2.0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, t, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, di)) + dt_shift)).astype(
        np.float32)
    a = -np.exp(rng.uniform(0, 2, (di, n))).astype(np.float32)
    b_t = rng.standard_normal((b, t, n)).astype(np.float32)
    c_t = rng.standard_normal((b, t, n)).astype(np.float32)
    return u, dt, a, b_t, c_t


def rel(got, want):
    return float(np.linalg.norm(N(got) - N(want)) / np.linalg.norm(N(want)))


# ------------------------------------------------------------ the scan
# (B, T, Di, N, chunk): T a multiple of the chunk; ragged T (the last chunk
# padded with dt = 0); T below one chunk; one step; a wide chunk
@pytest.mark.parametrize("b,t,di,n,chunk", [(2, 64, 12, 8, 16),
                                            (2, 37, 12, 8, 16),
                                            (1, 9, 20, 16, 16),
                                            (3, 1, 5, 4, 16),
                                            (1, 300, 8, 16, 256)])
@pytest.mark.parametrize("return_state", [False, True])
def test_scan_plain_equals_jax(b, t, di, n, chunk, return_state):
    ops = scan_operands(b * 100 + t, b, t, di, n)
    got = selective_scan_plain(*map(T, ops), chunk=chunk,
                               return_state=return_state)
    want = j_ssm._selective_scan_chunked(*map(jnp.asarray, ops), chunk,
                                         return_state=return_state)
    if return_state:
        (y, h), (jy, jh) = got, want
        assert h.shape == (b, di, n) and h.dtype == torch.float32
        assert rel(h, jh) <= SCAN_RTOL
    else:
        y, jy = got, want
    assert y.shape == (b, t, di) and y.dtype == torch.float32
    assert rel(y, jy) <= SCAN_RTOL


def test_scan_plain_equals_a_float64_recurrence():
    """The chunked scan is the step recurrence: h_t = exp(dt a) h + dt u b,
    y_t = sum_n h c, from h = 0."""
    u, dt, a, b_t, c_t = scan_operands(3, 2, 45, 6, 8, dt_shift=0.0)
    y, h = selective_scan_plain(*map(T, (u, dt, a, b_t, c_t)), chunk=16,
                                return_state=True)
    hh = np.zeros((2, 6, 8))
    ys = []
    for i in range(45):
        hh = (np.exp(dt[:, i, :, None].astype(np.float64) * a) * hh
              + (dt[:, i] * u[:, i])[..., None] * b_t[:, i, None, :])
        ys.append((hh * c_t[:, i, None, :]).sum(-1))
    np.testing.assert_allclose(N(y), np.stack(ys, 1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(N(h), hh, rtol=1e-5, atol=1e-6)


def test_scan_bf16_operands_are_cast_before_the_products():
    ops = [T(x).to(torch.bfloat16) for x in scan_operands(4, 1, 20, 8, 8)]
    ops[2] = ops[2].float()                          # a stays fp32
    y = selective_scan_plain(*ops, chunk=16)
    want = selective_scan_plain(*(x.float() for x in ops), chunk=16)
    assert y.dtype == torch.float32
    assert torch.equal(y, want)


def test_scan_wrapper_takes_the_plain_route_on_the_cpu():
    ops = list(map(T, scan_operands(5, 2, 20, 4, 8)))
    reset_launch_counts()
    calls = selective_scan_plain.calls
    y, h = selective_scan(*ops, return_state=True, chunk=8)
    assert selective_scan_plain.calls == calls + 1
    assert launch_counts()["selective_scan"] == 0
    want_y, want_h = selective_scan_plain(*ops, return_state=True, chunk=8)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert torch.equal(selective_scan(*ops, chunk=8), want_y)


def test_scan_wrapper_refuses_bad_operands():
    u, dt, a, b_t, c_t = map(T, scan_operands(6, 1, 4, 4, 8))
    with pytest.raises(ShapeContractError):
        selective_scan(u, dt, a[:, :4], b_t, c_t)
    with pytest.raises(ShapeContractError):
        selective_scan(u, dt[:, :3], a, b_t, c_t)
    with pytest.raises(TypeError, match="disagree"):
        selective_scan(u, dt.to(torch.bfloat16), a, b_t, c_t)
    with pytest.raises(TypeError, match="fp32 a"):
        selective_scan(u, dt, a.double(), b_t, c_t)
    with pytest.raises(TypeError):
        selective_scan(u.long(), dt.long(), a, b_t.long(), c_t.long())


# ----------------------------------------------------------- the block
def test_init_ssm_params_matches_the_jax_tree(block):
    cfg, jp, _ = block
    tp = t_ssm.init_ssm_params(7, cfg, torch.float32, device="cpu")
    assert isinstance(tp, t_ssm.Mamba)
    for name in t_ssm.KEYS:
        assert tuple(tp[name].shape) == jp[name].shape, name
    # log(1..N) from two libms: one ulp apart at most
    np.testing.assert_allclose(N(tp["a_log"]), np.asarray(jp["a_log"]),
                               rtol=2 ** -23, atol=0)
    for name in ("conv_b", "dt_bias", "d_skip"):
        np.testing.assert_array_equal(N(tp[name]), np.asarray(jp[name]))
    assert t_ssm.d_inner(cfg) == 2 * cfg.d_model
    with pytest.raises(ValueError, match="a_log"):
        t_ssm.Mamba({k: v for k, v in jp.items() if k != "a_log"})


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_equals_jax(with_state):
    x, w, b = rand(1, 2, 7, 16), rand(2, 4, 16), rand(3, 16)
    state = rand(4, 2, 3, 16) if with_state else None
    out, new = t_ssm._causal_conv(T(x), T(w), T(b),
                                  None if state is None else T(state))
    j_out, j_new = j_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b),
                                      None if state is None else jnp.asarray(state))
    np.testing.assert_allclose(N(out), N(j_out), **LAYER)
    np.testing.assert_array_equal(N(new), N(j_new))


def test_mamba_block_prefill_equals_jax(block):
    cfg, jp, tp = block
    x = rand(8, 2, 40, cfg.d_model)                 # 40: past two chunks
    out, conv, ssm = t_ssm.mamba_block(cfg, T(x), tp)
    j_out, j_conv, j_ssm_state = j_ssm.mamba_block(cfg, jnp.asarray(x), jp)
    np.testing.assert_allclose(N(out), N(j_out), **LAYER)
    np.testing.assert_array_equal(N(conv), N(j_conv))
    np.testing.assert_allclose(N(ssm), N(j_ssm_state), **LAYER)
    assert ssm.dtype == torch.float32


def test_mamba_block_decode_step_equals_jax(block):
    cfg, jp, tp = block
    conv, ssm = rand(9, 2, 3, 2 * cfg.d_model), rand(10, 2, 2 * cfg.d_model, 8)
    x = rand(11, 2, 1, cfg.d_model)
    out, nc, ns = t_ssm.mamba_block(cfg, T(x), tp, conv_state=T(conv),
                                    ssm_state=T(ssm), decode=True)
    j_out, j_nc, j_ns = j_ssm.mamba_block(cfg, jnp.asarray(x), jp,
                                          conv_state=jnp.asarray(conv),
                                          ssm_state=jnp.asarray(ssm),
                                          decode=True)
    np.testing.assert_allclose(N(out), N(j_out), **LAYER)
    np.testing.assert_allclose(N(nc), N(j_nc), **LAYER)
    np.testing.assert_allclose(N(ns), N(j_ns), **LAYER)
    with pytest.raises(InvariantError, match="recurrent state"):
        t_ssm.mamba_block(cfg, T(x), tp, conv_state=T(conv), decode=True)


def test_decode_from_a_prefill_equals_a_longer_prefill(block):
    """The states prefill hands to decode are the ones a longer prefill
    reaches: prefill T - 1 steps + one decode step == the last step of a
    prefill of T; a zeroed ssm state fails the same check."""
    cfg, _, tp = block
    x = T(rand(12, 2, 23, cfg.d_model))
    want, _, _ = t_ssm.mamba_block(cfg, x, tp)
    _, conv, ssm = t_ssm.mamba_block(cfg, x[:, :-1], tp)
    got, _, _ = t_ssm.mamba_block(cfg, x[:, -1:], tp, conv_state=conv,
                                  ssm_state=ssm, decode=True)
    np.testing.assert_allclose(N(got), N(want[:, -1:]), **LAYER)
    bad, _, _ = t_ssm.mamba_block(cfg, x[:, -1:], tp, conv_state=conv,
                                  ssm_state=torch.zeros_like(ssm), decode=True)
    assert not np.allclose(N(bad), N(want[:, -1:]), **LAYER)


def test_init_states_are_zero_and_shaped_as_jax(block):
    cfg, _, _ = block
    conv, ssm = t_ssm.init_states(cfg, 3, device="cpu")
    j_conv, j_ssm_state = j_ssm.init_states(cfg, 3)
    assert tuple(conv.shape) == j_conv.shape and conv.dtype == torch.float32
    assert tuple(ssm.shape) == j_ssm_state.shape and ssm.dtype == torch.float32
    assert not conv.any() and not ssm.any()
