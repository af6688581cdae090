"""The recurrences' backward passes on the CPU, held against the JAX
package and against float64.

On the CPU ``rwkv6`` and ``selective_scan`` run under autograd through
their ``torch.autograd.Function``s (``WKV6``, ``SelectiveScan``), whose
backward there is the kernels' plain version (``rwkv6_bwd_plain``,
``selective_scan_bwd_plain``).  On the same numpy-drawn inputs and output
gradients, every gradient is held within 1e-5 in relative Frobenius norm:

* WKV-6 against ``jax.grad`` of ``ref.rwkv6_scan_with_state`` (with a start
  state and a final-state gradient) and of ``ref.rwkv6_chunked(chunk=32,
  return_state=True)``; T not a multiple of the backward kernel's tiles (16,
  32), w ~ N(-6, 1) (the model's ``w_base``) and w near 0: N(0, 1) (decay
  down to e^-20 a step) against the scan and float64, N(0, 0.5) against
  the chunked form, whose own gradient is not finite at N(0, 1) (its
  masked ``exp`` of the upper triangle overflows, and ``jnp.where``'s
  gradient multiplies the inf by 0);
* the scan against ``jax.grad`` of ``ssm._selective_scan_chunked`` (with
  the final state's gradient), N 8, 16 and 32, T ragged against the chunk;
* both against the recurrences written out in float64 and differentiated
  by torch's autograd.

Operands drawn in bf16 are held twice: their values in fp32 within 1e-5 as
above, and the bf16 path itself (gradients rounded to bf16 once, on both
sides) within the card's bf16 limit of 2^-7, since one bf16 ULP (2^-8
relative) where the two round a sum to opposite sides already exceeds
1e-5.  The card's kernels are held against autograd of the plain forwards
in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.  Last: training runs
through the Functions (the plain backward is called once a layer), and
AdamW's update of a large weight in pieces gives the bits of one pass."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.models import ssm as j_ssm
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import rwkv6 as wk
from repro_torch.kernels import selective_scan as ss
from repro_torch.models import jamba as jb
from repro_torch.models import rwkv as rw
from repro_torch.optim import adamw

TOL = 1e-5
BF16_TOL = 2.0 ** -7


def rel(got, want) -> float:
    got = torch.as_tensor(np.asarray(got, dtype=np.float64)) if not isinstance(
        got, torch.Tensor) else got.double()
    want = torch.as_tensor(np.asarray(want, dtype=np.float64))
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


def bf16_values(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 and back to fp32."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


# ------------------------------------------------------------------ WKV-6
# (B, T, H, w mean, start state and final-state gradient, bf16 values)
WKV_CASES = [
    (2, 37, 3, -6.0, True, False),
    (1, 45, 2, 0.0, True, False),
    (2, 33, 2, -6.0, False, False),
    (1, 50, 2, 0.0, False, True),
    (2, 20, 2, -6.0, True, True),
]


def wkv_inputs(seed, b, t, h, w_mean, states, bf16, w_std=1.0):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    r, k, v, w = (draw(b, t, h, 64) for _ in range(4))
    w = w * np.float32(w_std) + np.float32(w_mean)
    if bf16:
        r, k, v, w = (bf16_values(x) for x in (r, k, v, w))
    u = draw(h, 64)
    s0 = draw(b, h, 64, 64) if states else None
    dout = draw(b, t, h, 64)
    dstate = draw(b, h, 64, 64)
    return (r, k, v, w, u), s0, dout, dstate


def torch_wkv_grads(ops, s0, dout, dstate, dtype=torch.float32):
    """Autograd of ``rwkv6`` through ``WKV6`` on the CPU."""
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_() for x in ops[:4]]
    leaves.append(torch.from_numpy(ops[4]).requires_grad_())
    if s0 is not None:
        leaves.append(torch.from_numpy(s0).requires_grad_())
    calls = wk.rwkv6_bwd_plain.calls
    out, state = wk.rwkv6(*leaves[:5], state0=leaves[5] if s0 is not None
                          else None)
    loss = (out * torch.from_numpy(dout)).sum() + (
        state * torch.from_numpy(dstate)).sum()
    grads = torch.autograd.grad(loss, leaves)
    assert wk.rwkv6_bwd_plain.calls == calls + 1
    return grads


def jax_wkv_grads(fn, ops, s0, dout, dstate):
    def loss(*args):
        out, state = fn(*args)
        return jnp.sum(out * dout) + jnp.sum(state * dstate)

    args = tuple(jnp.asarray(x) for x in ops) + (
        () if s0 is None else (jnp.asarray(s0),))
    return jax.grad(loss, argnums=tuple(range(len(args))))(*args)


def wkv64_grads(ops, s0, dout, dstate):
    """The recurrence in float64, differentiated by torch's autograd."""
    leaves = [torch.from_numpy(x).double().requires_grad_() for x in ops]
    if s0 is not None:
        leaves.append(torch.from_numpy(s0).double().requires_grad_())
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
    loss = (torch.stack(outs, 1) * torch.from_numpy(dout).double()).sum() + (
        state * torch.from_numpy(dstate).double()).sum()
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_wkv6_backward_equals_jax_grad_of_scan_with_state(case):
    b, t, h, w_mean, states, bf16 = case
    ops, s0, dout, dstate = wkv_inputs(t + h, b, t, h, w_mean, states, bf16)
    got = torch_wkv_grads(ops, s0, dout, dstate)
    want = jax_wkv_grads(
        lambda r, k, v, w, u, *s: ref.rwkv6_scan_with_state(
            r, k, v, w, u, s[0] if s else None), ops, s0, dout, dstate)
    assert len(got) == len(want) == 5 + (s0 is not None)
    for name, g, j in zip(wk.GRAD_NAMES, got, want, strict=False):
        assert rel(g, j) <= TOL, (name, rel(g, j))


@pytest.mark.parametrize("case", [c for c in WKV_CASES if not c[4]], ids=str)
def test_wkv6_backward_equals_jax_grad_of_chunked(case):
    """The chunked-parallel schedule the rwkv6-1.6b config names
    (``wkv_chunk=32``), T not a multiple of its chunk; zero start state."""
    b, t, h, w_mean, _, bf16 = case
    ops, _, dout, dstate = wkv_inputs(t + 2 * h, b, t, h, w_mean, False, bf16,
                                      w_std=1.0 if w_mean else 0.5)
    got = torch_wkv_grads(ops, None, dout, dstate)
    want = jax_wkv_grads(
        lambda *a: ref.rwkv6_chunked(*a, chunk=32, return_state=True), ops,
        None, dout, dstate)
    for name, g, j in zip(wk.GRAD_NAMES[:5], got, want, strict=True):
        assert rel(g, j) <= TOL, (name, rel(g, j))


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_wkv6_backward_equals_float64_autograd(case):
    b, t, h, w_mean, states, bf16 = case
    ops, s0, dout, dstate = wkv_inputs(3 * t + h, b, t, h, w_mean, states, bf16)
    got = torch_wkv_grads(ops, s0, dout, dstate)
    want = wkv64_grads(ops, s0, dout, dstate)
    for name, g, j in zip(wk.GRAD_NAMES, got, want, strict=False):
        assert rel(g, j.numpy()) <= TOL, (name, rel(g, j.numpy()))


@pytest.mark.parametrize("case", [c for c in WKV_CASES if c[5]], ids=str)
def test_wkv6_bf16_backward_within_the_bf16_limit(case):
    """bf16 operands through ``WKV6``: dr, dk, dv, dw come back in bf16,
    each within 2^-7 of the bf16 rounding of JAX's fp32 gradient."""
    b, t, h, w_mean, states, _ = case
    ops, s0, dout, dstate = wkv_inputs(t + h, b, t, h, w_mean, states, True)
    got = torch_wkv_grads(ops, s0, dout, dstate, dtype=torch.bfloat16)
    assert all(g.dtype == torch.bfloat16 for g in got[:4])
    assert got[4].dtype == torch.float32          # u stays fp32
    want = jax_wkv_grads(
        lambda r, k, v, w, u, *s: ref.rwkv6_scan_with_state(
            r, k, v, w, u, s[0] if s else None), ops, s0, dout, dstate)
    for name, g, j in zip(wk.GRAD_NAMES, got, want, strict=False):
        assert rel(g.float(), bf16_values(np.asarray(j))) <= BF16_TOL, name


# ---------------------------------------------------------- the scan
# (B, T, Di, N, chunk, dt mean, final-state gradient, bf16 values)
SCAN_CASES = [
    (2, 37, 12, 8, 16, -4.0, True, False),
    (1, 70, 20, 16, 32, -4.0, True, False),
    (2, 45, 10, 32, 16, 0.0, False, False),
    (1, 33, 16, 16, 256, 1.0, True, True),
    (2, 20, 8, 8, 8, -4.0, False, True),
]


def scan_inputs(seed, b, t, di, n, dt_mean, bf16):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    u = draw(b, t, di)
    dt = np.log1p(np.exp(draw(b, t, di) + np.float32(dt_mean))).astype(np.float32)
    b_t, c_t = draw(b, t, n), draw(b, t, n)
    if bf16:
        u, dt, b_t, c_t = (bf16_values(x) for x in (u, dt, b_t, c_t))
    a = -(np.arange(1, n + 1, dtype=np.float32)[None]
          * (1 + 0.1 * rng.random((di, 1), dtype=np.float32)))
    return (u, dt, a.astype(np.float32), b_t, c_t), draw(b, t, di), draw(b, di, n)


def torch_scan_grads(ops, dy, dh, chunk, dtype=torch.float32):
    leaves = [torch.from_numpy(x).to(dtype if i != 2 else torch.float32)
              .requires_grad_() for i, x in enumerate(ops)]
    calls = ss.selective_scan_bwd_plain.calls
    y, state = ss.selective_scan(*leaves, return_state=True, chunk=chunk)
    loss = (y * torch.from_numpy(dy)).sum()
    if dh is not None:
        loss = loss + (state * torch.from_numpy(dh)).sum()
    grads = torch.autograd.grad(loss, leaves)
    assert ss.selective_scan_bwd_plain.calls == calls + 1
    return grads


def jax_scan_grads(ops, dy, dh, chunk):
    def loss(*args):
        y, state = j_ssm._selective_scan_chunked(*args, chunk,
                                                 return_state=True)
        out = jnp.sum(y * dy)
        return out if dh is None else out + jnp.sum(state * dh)

    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(x) for x in ops))


def scan64_grads(ops, dy, dh):
    leaves = [torch.from_numpy(x).double().requires_grad_() for x in ops]
    u, dt, a, b_t, c_t = leaves
    h = torch.zeros((u.shape[0], u.shape[2], a.shape[1]), dtype=torch.float64)
    ys = []
    for i in range(u.shape[1]):
        h = (torch.exp(dt[:, i, :, None] * a) * h
             + (dt[:, i] * u[:, i])[..., None] * b_t[:, i, None, :])
        ys.append((h * c_t[:, i, None, :]).sum(-1))
    loss = (torch.stack(ys, 1) * torch.from_numpy(dy).double()).sum()
    if dh is not None:
        loss = loss + (h * torch.from_numpy(dh).double()).sum()
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("case", SCAN_CASES, ids=str)
def test_scan_backward_equals_jax_grad_of_chunked_scan(case):
    b, t, di, n, chunk, dt_mean, with_dh, bf16 = case
    ops, dy, dh = scan_inputs(t + di + n, b, t, di, n, dt_mean, bf16)
    dh = dh if with_dh else None
    got = torch_scan_grads(ops, dy, dh, chunk)
    want = jax_scan_grads(ops, dy, dh, chunk)
    for name, g, j in zip(ss.GRAD_NAMES, got, want, strict=True):
        assert rel(g, j) <= TOL, (name, rel(g, j))


@pytest.mark.parametrize("case", SCAN_CASES, ids=str)
def test_scan_backward_equals_float64_autograd(case):
    b, t, di, n, chunk, dt_mean, with_dh, bf16 = case
    ops, dy, dh = scan_inputs(2 * t + di + n, b, t, di, n, dt_mean, bf16)
    dh = dh if with_dh else None
    got = torch_scan_grads(ops, dy, dh, chunk)
    want = scan64_grads(ops, dy, dh)
    for name, g, j in zip(ss.GRAD_NAMES, got, want, strict=True):
        assert rel(g, j.numpy()) <= TOL, (name, rel(g, j.numpy()))


@pytest.mark.parametrize("case", [c for c in SCAN_CASES if c[7]], ids=str)
def test_scan_bf16_backward_within_the_bf16_limit(case):
    """bf16 operands through ``SelectiveScan``: du, ddt, db, dc in bf16 and
    da in fp32, each within 2^-7 of (the bf16 rounding of) JAX's."""
    b, t, di, n, chunk, dt_mean, with_dh, _ = case
    ops, dy, dh = scan_inputs(t + di + n, b, t, di, n, dt_mean, True)
    dh = dh if with_dh else None
    got = torch_scan_grads(ops, dy, dh, chunk, dtype=torch.bfloat16)
    assert [g.dtype for g in got] == [torch.bfloat16] * 2 + [torch.float32] + [
        torch.bfloat16] * 2
    want = jax_scan_grads(ops, dy, dh, chunk)
    for name, g, j in zip(ss.GRAD_NAMES, got, want, strict=True):
        assert rel(g.float(), bf16_values(np.asarray(j))) <= BF16_TOL, name


# --------------------------------------------- training and the optimizer
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_cpu_training_runs_the_plain_backwards(arch):
    """``loss_fn``'s backward on the CPU calls the plain backward once a
    recurrent layer (remat off) and launches no kernel."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    cfg = dataclasses.replace(reduced(get_config(arch)), remat=False)
    model, plain = ((rw, wk.rwkv6_bwd_plain) if cfg.family == "ssm"
                    else (jb, ss.selective_scan_bwd_plain))
    layers = (cfg.n_layers if cfg.family == "ssm" else
              sum(not jb.is_attn_layer(cfg, l) for l in range(cfg.n_layers)))
    params = model.init_params(cfg, 0, device="cpu").requires_grad_(True)
    tok = torch.zeros((1, 16), dtype=torch.long)
    reset_launch_counts()
    calls = plain.calls
    loss = model.loss_fn(cfg, params, tok, tok)
    torch.autograd.grad(loss, list(params.parameters()), allow_unused=True)
    assert plain.calls == calls + layers
    assert not any(launch_counts().values())


def test_adamw_update_in_pieces_equals_one_pass(monkeypatch):
    """A weight larger than ``_PIECE`` is updated in flat pieces: the same
    bits as one pass over it, in fp32 and bf16 weights."""
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
        w = {"big": torch.from_numpy(rng.standard_normal((7, 300))
                                     .astype(np.float32)).to(dtype),
             "small": torch.from_numpy(rng.standard_normal(5)
                                       .astype(np.float32)).to(dtype)}
        g = {k: torch.from_numpy(rng.standard_normal(v.shape)
                                 .astype(np.float32)) for k, v in w.items()}
        opt = adamw.AdamW()
        runs = []
        for piece in (1 << 26, 256):
            monkeypatch.setattr(adamw, "_PIECE", piece)
            params = {k: v.clone() for k, v in w.items()}
            state = opt.init(params)
            for _ in range(3):
                params, state, _ = opt.update(g, state, params, 1e-3)
            runs.append((params, state))
        (p1, s1), (p2, s2) = runs
        for k in w:
            assert torch.equal(p1[k], p2[k])
            assert torch.equal(s1.mu[k], s2.mu[k])
            assert torch.equal(s1.nu[k], s2.nu[k])
