"""The chunked WKV-6 backward's arithmetic on the CPU: its plain version,
``rwkv6_bwd_chunked_plain``, against autograd and the JAX package.

``rwkv6_bwd_chunked_plain`` mirrors the card's ``chunked`` instance
(``csrc/rwkv6_bwd.cu``): S at every 64-step chunk's start and G at its end
by the chunk recurrences, the same two recurrences over 16-step
sub-chunks, the state terms of dr, dk and dv from them, the diagonal
sub-chunk pairs with exact gates, and dw as boundary, state and straddling
terms inside the sub-chunk (nothing divided by a decay, no sum past the
sub-chunk).  On numpy-drawn inputs it is held, per gradient, in relative
Frobenius norm:

* in float64 against the recurrence written out in float64 and
  differentiated by torch's autograd, within 1e-10;
* in float32 against the same float64 gradients, against
  ``torch.autograd.grad`` of ``rwkv6_plain`` (fp32) and against
  ``jax.grad`` of ``ref.rwkv6_scan_with_state`` (fp32), within 1e-5;

at w ~ N(-6, 1) (the model's ``w_base``), N(0, 0.5) and N(0, 1) (decay
down to e^-20 a step and below, where ``ref.rwkv6_chunked``'s own
gradient is not finite), with and without a start state and a final-state
gradient, T a multiple of the chunk and ragged.  The chooser is pure and
asked here; the card's instances are held in ``tests/test_torch_gpu.py``
and ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import rwkv6 as wk

TOL32 = 1e-5
TOL64 = 1e-10

# (B, T, H, w mean, w std, start state and final-state gradient)
CASES = [
    (1, 128, 2, -6.0, 1.0, True),
    (2, 77, 1, -6.0, 1.0, False),
    (1, 150, 2, 0.0, 0.5, True),
    (2, 64, 1, 0.0, 0.5, False),
    (1, 93, 2, 0.0, 1.0, True),
    (1, 128, 1, 0.0, 1.0, False),
]


def inputs(case):
    b, t, h, w_mean, w_std, states = case
    rng = np.random.default_rng(t * 10 + h + int(w_std * 4))

    def draw(*shape):
        return rng.standard_normal(shape)

    r, k, v, w = (draw(b, t, h, 64) for _ in range(4))
    w = w * w_std + w_mean
    u = draw(h, 64)
    s0 = draw(b, h, 64, 64) if states else None
    dstate = draw(b, h, 64, 64) if states else None
    dout = draw(b, t, h, 64)
    return (r, k, v, w, u), s0, dout, dstate


def rel(got, want) -> float:
    got = torch.as_tensor(np.asarray(got, dtype=np.float64))
    want = torch.as_tensor(np.asarray(want, dtype=np.float64))
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


def as_t(x, dtype):
    return None if x is None else torch.from_numpy(x).to(dtype)


def chunked(ops, s0, dout, dstate, dtype):
    """``rwkv6_bwd_chunked_plain`` on the inputs in ``dtype`` (u in fp32
    beside fp32 operands, as the models hold it)."""
    udt = torch.float64 if dtype == torch.float64 else torch.float32
    calls = wk.rwkv6_bwd_chunked_plain.calls
    got = wk.rwkv6_bwd_chunked_plain(
        *(as_t(x, dtype) for x in ops[:4]), as_t(ops[4], udt),
        as_t(dout, dtype), state0=as_t(s0, dtype), dstate=as_t(dstate, dtype))
    assert wk.rwkv6_bwd_chunked_plain.calls == calls + 1
    return got


def float64_grads(ops, s0, dout, dstate):
    """The recurrence in float64, differentiated by torch's autograd."""
    leaves = [torch.from_numpy(x).requires_grad_() for x in ops]
    if s0 is not None:
        leaves.append(torch.from_numpy(s0).requires_grad_())
    r, k, v, w, u = leaves[:5]
    b, t, h, d = k.shape
    state = leaves[5] if s0 is not None else torch.zeros(
        (b, h, d, d), dtype=torch.float64)
    decay = torch.exp(-torch.exp(w))
    outs = []
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, i],
                                 state + u[None, :, :, None] * kv))
        state = state * decay[:, i, :, :, None] + kv
    loss = (torch.stack(outs, 1) * torch.from_numpy(dout)).sum()
    if dstate is not None:
        loss = loss + (state * torch.from_numpy(dstate)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def plain_fp32_grads(ops, s0, dout, dstate):
    """``torch.autograd.grad`` of ``rwkv6_plain`` in fp32."""
    leaves = [as_t(x, torch.float32).requires_grad_() for x in ops]
    if s0 is not None:
        leaves.append(as_t(s0, torch.float32).requires_grad_())
    out, state = wk.rwkv6_plain(*leaves[:5], state0=leaves[5] if s0 is not None
                                else None)
    loss = (out * as_t(dout, torch.float32)).sum()
    if dstate is not None:
        loss = loss + (state * as_t(dstate, torch.float32)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def jax_grads(ops, s0, dout, dstate):
    """``jax.grad`` of ``ref.rwkv6_scan_with_state`` in fp32."""
    f32 = [np.asarray(x, np.float32) for x in ops]
    args = tuple(jnp.asarray(x) for x in f32) + (
        () if s0 is None else (jnp.asarray(np.asarray(s0, np.float32)),))
    do = jnp.asarray(np.asarray(dout, np.float32))
    ds = None if dstate is None else jnp.asarray(np.asarray(dstate, np.float32))

    def loss(*a):
        out, state = ref.rwkv6_scan_with_state(*a[:5], a[5] if len(a) > 5
                                               else None)
        total = jnp.sum(out * do)
        return total if ds is None else total + jnp.sum(state * ds)

    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(
        range(len(args))))(*args)]


def check(got, want, tol):
    names = wk.GRAD_NAMES[:len(want)]
    for name, g, w in zip(names, got, want, strict=True):
        assert rel(g.detach().double().numpy(), w) <= tol, (name, rel(
            g.detach().double().numpy(), w))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_chunked_float64_equals_float64_autograd(case):
    ops, s0, dout, dstate = inputs(case)
    got = chunked(ops, s0, dout, dstate, torch.float64)
    assert (got[5] is None) == (s0 is None)
    check([g for g in got if g is not None], float64_grads(ops, s0, dout,
                                                           dstate), TOL64)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_chunked_float32_equals_float64_autograd(case):
    ops, s0, dout, dstate = inputs(case)
    got = chunked(ops, s0, dout, dstate, torch.float32)
    assert all(g.dtype == torch.float32 for g in got if g is not None)
    check([g for g in got if g is not None], float64_grads(ops, s0, dout,
                                                           dstate), TOL32)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_chunked_float32_equals_autograd_of_rwkv6_plain(case):
    ops, s0, dout, dstate = inputs(case)
    got = chunked(ops, s0, dout, dstate, torch.float32)
    check([g for g in got if g is not None],
          plain_fp32_grads(ops, s0, dout, dstate), TOL32)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_chunked_float32_equals_jax_grad_of_scan_with_state(case):
    ops, s0, dout, dstate = inputs(case)
    got = chunked(ops, s0, dout, dstate, torch.float32)
    check([g for g in got if g is not None], jax_grads(ops, s0, dout, dstate),
          TOL32)


def test_chunked_bf16_operands_come_back_in_bf16():
    """bf16 operands (the card's chunked instance takes only these): dr,
    dk, dv, dw in bf16 within 2^-7 of the float64 gradients of the same
    bf16 values; du in u's fp32."""
    ops, s0, dout, dstate = inputs(CASES[0])
    vals = [torch.from_numpy(x).bfloat16().double().numpy() for x in ops[:4]]
    got = wk.rwkv6_bwd_chunked_plain(
        *(torch.from_numpy(x).bfloat16() for x in ops[:4]),
        as_t(ops[4], torch.float32), as_t(dout, torch.float32),
        state0=as_t(s0, torch.float32), dstate=as_t(dstate, torch.float32))
    assert all(g.dtype == torch.bfloat16 for g in got[:4])
    assert got[4].dtype == torch.float32 and got[5].dtype == torch.float32
    want = float64_grads(vals + [ops[4]], s0, dout, dstate)
    for name, g, w in zip(wk.GRAD_NAMES, got, want, strict=True):
        assert rel(g.double().numpy(), w) <= 2.0 ** -7, name


def test_chunked_no_steps():
    ops, s0, dout, dstate = inputs(CASES[0])
    cut = [torch.from_numpy(x[:, :0]).float() for x in ops[:4]]
    got = wk.rwkv6_bwd_chunked_plain(
        *cut, as_t(ops[4], torch.float32), torch.zeros((1, 0, 2, 64)),
        state0=as_t(s0, torch.float32), dstate=as_t(dstate, torch.float32))
    assert all(g.shape == x.shape for g, x in zip(got[:4], cut, strict=True))
    assert not got[4].any()
    assert torch.equal(got[5], as_t(dstate, torch.float32))


def plant(monkeypatch, fault):
    """Plant ``fault`` in ``rwkv6_bwd_chunked_plain`` for this test:
    ``"chunk_state"`` hands each chunk the start state of the chunk before
    it; ``"gate"`` swaps the sums of log-decay before and after each step
    of a sub-chunk (every gate referenced to the sub-chunk's wrong end)."""
    if fault == "chunk_state":
        scan = wk._chunk_scan

        def shifted(tot, x, init, *, reverse=False):
            states, last = scan(tot, x, init, reverse=reverse)
            return (states if reverse else states[:1] + states[:-1]), last

        monkeypatch.setattr(wk, "_chunk_scan", shifted)
    else:
        sums = wk._gate_sums
        monkeypatch.setattr(wk, "_gate_sums", lambda lq: sums(lq)[::-1])


@pytest.mark.parametrize("fault", ["chunk_state", "gate"])
def test_chunked_planted_faults_miss_the_limit(fault, monkeypatch):
    """The faults ``chip_smoke.py`` and the card tests plant (a chunk state
    from the wrong chunk, the sub-chunk states' gates referenced to the
    wrong end) move the gradients far past the bf16 limit."""
    ops, s0, dout, dstate = inputs(CASES[0])
    args = [as_t(x, torch.float32) for x in ops] + [as_t(dout, torch.float32)]
    good = wk.rwkv6_bwd_chunked_plain(*args, state0=as_t(s0, torch.float32),
                                      dstate=as_t(dstate, torch.float32))
    plant(monkeypatch, fault)
    bad = wk.rwkv6_bwd_chunked_plain(*args, state0=as_t(s0, torch.float32),
                                     dstate=as_t(dstate, torch.float32))
    assert not wk.grad_agreement(bad, good)["ok"]
    assert max(rel(b.numpy(), g.numpy()) for b, g in zip(bad, good, strict=True)
               if g is not None) > 2.0 ** -7


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "chunked"),
                                        (torch.float32, "sweep")])
def test_choose_bwd_instance_by_dtype(dtype, want):
    """Pure: bf16 operands (the training path) take ``chunked``, fp32 ones
    ``sweep``, contiguous or as views of a fused projection."""
    x = torch.zeros((2, 50, 3, 64), dtype=dtype)
    assert wk.choose_bwd_instance(x, x, x, x) == want
    fused = torch.zeros((2, 50, 3, 4 * 64 + 1), dtype=dtype)[..., 1:]
    assert wk.choose_bwd_instance(*fused.split(64, dim=-1)) == want
    assert wk.BWD_INSTANCES == ("chunked", "sweep")
