"""The flash-attention backward's plain version and autograd function on
the CPU, against autograd and against JAX.

``flash_attention_bwd_plain`` (the recompute formulas the CUDA kernel
runs: ``P = exp(S scale - lse)``, ``D = rowsum(dO o O)``, ``dS = P o (dP -
D)``) against autograd of ``flash_attention_plain`` and against
``jax.grad`` of the reference's ``attention_chunked`` (causal T == S,
non-causal T != S, GQA), within ``grad_agreement``'s fp32 limits (1e-5
relative Frobenius per gradient, 1e-4 of |ref| + the row's rms + a tenth
of the gradient's rms per element); the forward's lse (+inf where a row
sees no key, whose gradients are 0); ``flash_attention`` under autograd
going through ``FlashAttention`` (one forward, the backward's plain
version, no kernel launch on the CPU); ``grad_agreement`` rejecting three
planted faults (D omitted, the scale dropped from dK, the GQA sum over one
head) in fp32 and bf16; the wrapper's operand checks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as j_layers
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import flash_attention as fa
from repro_torch.mpc.errors import ShapeContractError

# (B, T, S, Hq, Hkv, D, causal, q_offset)
CASES = [
    (2, 9, 9, 4, 2, 32, True, 0),        # causal, GQA 2
    (1, 16, 16, 8, 2, 64, True, 0),      # causal, GQA 4
    (2, 7, 11, 4, 1, 32, False, 0),      # non-causal T != S, GQA 4 (MQA)
    (1, 5, 12, 4, 4, 32, True, 7),       # q_offset: a prefill's tail
    (1, 8, 8, 2, 1, 64, True, -3),       # rows that see no key
]


def _draw(seed, *shape):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _operands(case, seed=0):
    b, t, s, hq, hkv, d = case[:6]
    return (_draw(seed, b, t, hq, d), _draw(seed + 1, b, s, hkv, d),
            _draw(seed + 2, b, s, hkv, d), _draw(seed + 3, b, t, hq, d))


def _plain_grads(q, k, v, do, causal, q_offset):
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                                      return_lse=True)
    return fa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                        q_offset=q_offset), o, lse


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_backward_equals_autograd_of_the_plain_forward(case):
    causal, q_offset = case[6], case[7]
    q, k, v, do = _operands(case)
    got, _, _ = _plain_grads(q, k, v, do, causal, q_offset)
    qs, ks, vs = (x.double().requires_grad_() for x in (q, k, v))
    out = fa.flash_attention_plain(qs, ks, vs, causal=causal, q_offset=q_offset)
    want = torch.autograd.grad(out, (qs, ks, vs), do.double())
    for g, w, x in zip(got, want, (q, k, v), strict=True):
        assert g.shape == x.shape and g.dtype == x.dtype
    a = fa.grad_agreement(got, want)
    assert a["ok"], a


@pytest.mark.parametrize("case", [c for c in CASES if c[7] == 0], ids=str)
def test_plain_backward_equals_jax_grad_of_attention_chunked(case):
    """The reference trains through XLA's autodiff of its online-softmax
    scan; small chunks so that the scan takes several steps."""
    causal = case[6]
    q, k, v, do = _operands(case, seed=5)

    def f(q_, k_, v_):
        out = j_layers.attention_chunked(q_, k_, v_, causal=causal, q_chunk=4,
                                         kv_chunk=4)
        return jnp.sum(out * jnp.asarray(do.numpy()))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x.numpy())
                                            for x in (q, k, v)))
    got, _, _ = _plain_grads(q, k, v, do, causal, 0)
    a = fa.grad_agreement(got, [torch.from_numpy(np.array(w)) for w in want])
    assert a["ok"], a


def test_lse_is_the_rows_logsumexp_and_inf_where_no_key_is_seen():
    q, k, v, _ = _operands(CASES[4])
    _, lse = fa.flash_attention_plain(q, k, v, causal=True, q_offset=-3,
                                      return_lse=True)
    assert lse.shape == (1, 2, 8) and lse.dtype == torch.float32
    assert torch.isinf(lse[..., :3]).all() and (lse[..., :3] > 0).all()
    qh = q.transpose(1, 2)
    kh = k.repeat_interleave(2, dim=2).transpose(1, 2)
    logits = qh @ kh.transpose(-1, -2) * 64 ** -0.5
    for i in range(3, 8):
        want = torch.logsumexp(logits[..., i, : i - 3 + 1], dim=-1)
        torch.testing.assert_close(lse[..., i], want, rtol=1e-6, atol=1e-6)


def test_rows_that_see_no_key_get_zero_gradients():
    q, k, v, do = _operands(CASES[4])
    (dq, dk, dv), _, _ = _plain_grads(q, k, v, do, True, -3)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all()
    assert not dq[:, :3].any()
    assert not dk[:, 5:].any() and not dv[:, 5:].any()   # keys nobody sees


def test_flash_attention_under_autograd_runs_the_backward_function():
    case = CASES[1]
    q, k, v, do = _operands(case)
    want, _, _ = _plain_grads(q, k, v, do, True, 0)
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    reset_launch_counts()
    calls = fa.flash_attention_plain.calls
    out = fa.flash_attention(qs, ks, vs, causal=True)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (qs, ks, vs), do)
    assert fa.flash_attention_plain.calls - calls == 1   # no forward again
    assert not any(launch_counts().values())             # CPU: plain versions
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    with torch.no_grad():
        assert fa.flash_attention(qs, ks, vs).grad_fn is None


def _faults(q, k, v, o, do, lse, causal, q_offset):
    """Three wrong backwards made with the plain version: D omitted (O = 0
    makes D = 0), the scale dropped from dK, and each kv-head's gradients
    from its group's first q-head only."""
    kw = dict(causal=causal, q_offset=q_offset)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, torch.zeros_like(o), do,
                                              lse, **kw)
    yield "D omitted", (dq, dk, dv)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    yield "scale dropped from dK", (dq, dk * q.shape[-1] ** 0.5, dv)
    group = q.shape[2] // k.shape[2]
    if group > 1:
        _, dk1, dv1 = fa.flash_attention_bwd_plain(
            q, k.repeat_interleave(group, 2), v.repeat_interleave(group, 2), o,
            do, lse, **kw)
        yield "GQA sum over one head", (dq, dk1[:, :, ::group], dv1[:, :, ::group])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_agreement_rejects_planted_faults(dtype):
    q, k, v, do = (x.to(dtype) for x in _operands(CASES[1], seed=9))
    (ref, o, lse) = _plain_grads(q, k, v, do, True, 0)
    assert fa.grad_agreement(ref, ref)["ok"]
    names = []
    for name, bad in _faults(q, k, v, o, do, lse, True, 0):
        names.append(name)
        assert not fa.grad_agreement(bad, ref)["ok"], name
    assert len(names) == 3


def test_grad_agreement_limits_by_dtype():
    ref = [torch.ones(1, 4, 2, 8)] * 3
    near = [r * (1 + 5e-6) for r in ref]
    assert fa.grad_agreement(near, ref)["ok"]
    assert not fa.grad_agreement([r * (1 + 5e-5) for r in ref], ref)["ok"]
    rb = [r.to(torch.bfloat16) for r in ref]
    assert fa.grad_agreement([r * (1 + 2 ** -8) for r in rb], rb)["ok"]
    assert not fa.grad_agreement([r * 1.02 for r in rb], rb)["ok"]
    nan = [torch.full_like(ref[0], float("nan"))] + ref[1:]
    assert not fa.grad_agreement(nan, ref)["ok"]


def test_backward_wrapper_checks_its_operands():
    q, k, v, do = _operands(CASES[0])
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    with pytest.raises(ShapeContractError):
        fa.flash_attention_bwd(q, k, v, o[:, :-1], do, lse)
    with pytest.raises(ShapeContractError):
        fa.flash_attention_bwd(q, k, v, o, do, lse.transpose(1, 2))
    with pytest.raises(ShapeContractError):
        fa.flash_attention_bwd(q, k, v, o, do, lse.double())
    with pytest.raises(ShapeContractError):
        fa.flash_attention_bwd(q, k[:, :, :1].expand(-1, -1, 3, -1),
                               v[:, :, :1].expand(-1, -1, 3, -1), o, do, lse)
    got = fa.flash_attention_bwd(q, k, v, o, do, lse)
    assert all(torch.equal(g, w) for g, w in zip(
        got, fa.flash_attention_bwd_plain(q, k, v, o, do, lse), strict=True))
