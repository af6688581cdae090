"""The port's WKV-6 recurrence (``kernels.rwkv6``) held against the JAX
package, on the CPU.

On the CPU the wrapper takes its plain version, the sequential recurrence
in fp32.  On the same numpy-drawn inputs it is held:

* at 1e-4 absolute and relative (the tolerance of ``tests/test_kernels.py``
  for WKV) against ``ref.rwkv6_ref``, the Pallas kernel run with
  ``interpret=True`` at that file's shapes, and
  ``ref.rwkv6_scan_with_state`` (output and final state, also from a
  given start state);
* at 5e-5 against ``ref.rwkv6_chunked(chunk=32, return_state=True)``,
  another schedule of the same function whose sums run in another order,
  with T not a multiple of the chunk and with strong decay;
* at 1e-4 against the recurrence in float64, at the model's head size.

The card's kernel is held against this plain version in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.rwkv6 import rwkv6 as pallas_rwkv6
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.rwkv6 import agreement, rwkv6, rwkv6_plain
from repro_torch.mpc.errors import ShapeContractError

WKV = dict(atol=1e-4, rtol=1e-4)
CHUNKED = dict(atol=5e-5, rtol=5e-5)


def operands(seed, b, t, h, dk, dv, *, w_mean=0.0):
    """r, k, v, w, u as float32 numpy arrays; w ~ N(w_mean, 1)."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return (draw(b, t, h, dk), draw(b, t, h, dk), draw(b, t, h, dv),
            (draw(b, t, h, dk) + w_mean).astype(np.float32), draw(h, dk))


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# the shapes of tests/test_kernels.py's Pallas case, with its block sizes
PALLAS_CASES = [
    (1, 16, 2, 8, 8, 8),
    (2, 50, 3, 16, 16, 16),   # T not a multiple of the block
    (1, 64, 1, 32, 16, 64),   # K != V
]


@pytest.mark.parametrize("b,t,h,dk,dv,bt", PALLAS_CASES)
def test_plain_equals_ref_and_pallas(b, t, h, dk, dv, bt):
    ops = operands(t, b, t, h, dk, dv)
    out, state = rwkv6(*map(T, ops))
    assert out.dtype == torch.float32 and out.shape == (b, t, h, dv)
    assert state.shape == (b, h, dk, dv)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.rwkv6_ref(*ops)),
                               **WKV)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(pallas_rwkv6(*ops, bt=bt, interpret=True)),
        **WKV)


@pytest.mark.parametrize("with_state0", [False, True])
@pytest.mark.parametrize("b,t,h,dk,dv", [(2, 37, 3, 16, 16), (1, 70, 2, 64, 64),
                                         (3, 5, 1, 32, 8)])
def test_plain_equals_scan_with_state(b, t, h, dk, dv, with_state0):
    ops = operands(b * t + dv, b, t, h, dk, dv)
    s0 = (np.random.default_rng(7).standard_normal((b, h, dk, dv))
          .astype(np.float32) if with_state0 else None)
    out, state = rwkv6(*map(T, ops), state0=None if s0 is None else T(s0))
    want_out, want_state = ref.rwkv6_scan_with_state(
        *ops, None if s0 is None else jnp.asarray(s0))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **WKV)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), **WKV)


# w around 0 is the strong decay of tests/test_kernels.py (e^-1 per step)
@pytest.mark.parametrize("w_mean", [-6.0, -2.0, 0.0])
@pytest.mark.parametrize("t", [32, 37, 45, 100])   # 37, 45, 100: ragged chunks
def test_plain_equals_chunked(t, w_mean):
    """At the head size of tests/test_kernels.py's chunked case (K = V = 8).
    With K = 64 the chunked form's own rounding (exp of cumulative decay
    differences) exceeds 5e-5 on outputs of magnitude 100; the float64 test
    below shows the plain version is the accurate one there."""
    ops = operands(t + int(10 * abs(w_mean)), 2, t, 2, 8, 8, w_mean=w_mean)
    out, state = rwkv6(*map(T, ops))
    want_out, want_state = ref.rwkv6_chunked(*ops, chunk=32, return_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **CHUNKED)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), **CHUNKED)


def float64_recurrence(r, k, v, w, u):
    """The recurrence in float64 numpy: the truth the fp32 versions round."""
    r, k, v, w, u = (x.astype(np.float64) for x in (r, k, v, w, u))
    b, t, h, dk = k.shape
    state = np.zeros((b, h, dk, v.shape[-1]))
    out = np.empty((b, t, h, v.shape[-1]))
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]
        out[:, i] = np.einsum("bhk,bhkv->bhv", r[:, i],
                              state + u[None, :, :, None] * kv)
        state = state * np.exp(-np.exp(w[:, i]))[..., None] + kv
    return out, state


@pytest.mark.parametrize("w_mean", [-6.0, 0.0, 1.5])
def test_plain_equals_float64_recurrence(w_mean):
    """K = V = 64, the model's head size, from weak to very strong decay."""
    ops = operands(int(w_mean * 10) % 97, 2, 100, 2, 64, 64, w_mean=w_mean)
    out, state = rwkv6(*map(T, ops))
    want_out, want_state = float64_recurrence(*ops)
    np.testing.assert_allclose(out.numpy(), want_out, **WKV)
    np.testing.assert_allclose(state.numpy(), want_state, **WKV)


def test_cancelled_bonus_meets_the_element_limit():
    """At t = 0 the output row is ``v_0 · Σ_k r u k``; when that sum cancels
    the row is tiny, and only an fp64 sum of the bonus keeps the row within
    ``agreement``'s element limit of the float64 recurrence (an fp32 sum
    is off by about 1e-3 relatively)."""
    r, k, v, w, u = operands(21, 1, 3, 2, 64, 64)
    r64, k64 = r[0, 0, 0].astype(np.float64), k[0, 0, 0].astype(np.float64)
    # choose u[0, 0] so that head 0's bonus at t = 0 cancels to about 1e-6
    rest = float((r64[1:] * u[0, 1:] * k64[1:]).sum())
    u[0, 0] = np.float32((1e-6 - rest) / (r64[0] * k64[0]))
    want_out, _ = float64_recurrence(r, k, v, w, u)
    a0 = float((r64 * u[0].astype(np.float64) * k64).sum())
    assert abs(a0) < 1e-4 * float(np.abs(r64 * u[0] * k64).sum())
    out, _ = rwkv6(*map(T, (r, k, v, w, u)))
    assert agreement(out, T(want_out).float())["ok"]
    fp32_sum = (T(r[0, 0, 0]) * T(u[0]) * T(k[0, 0, 0])).sum() * T(v[0, 0, 0])
    assert not agreement(fp32_sum, T(want_out[0, 0, 0]).float())["ok"]


def test_bf16_inputs_compute_in_fp32():
    ops = [T(x).to(torch.bfloat16) for x in operands(3, 1, 20, 2, 64, 64)]
    out, state = rwkv6(*ops)
    assert out.dtype == state.dtype == torch.float32
    want = ref.rwkv6_scan_with_state(*(x.float().numpy() for x in ops))
    np.testing.assert_allclose(out.numpy(), np.asarray(want[0]), **WKV)
    np.testing.assert_allclose(state.numpy(), np.asarray(want[1]), **WKV)


def test_state_carries_across_a_split_sequence():
    """Two calls, the second seeded with the first's state, equal one
    call over the whole sequence: the state is what decode resumes from."""
    r, k, v, w, u = map(T, operands(11, 2, 40, 2, 64, 64))
    out, state = rwkv6(r, k, v, w, u)
    a, mid = rwkv6(r[:, :25], k[:, :25], v[:, :25], w[:, :25], u)
    b, end = rwkv6(r[:, 25:], k[:, 25:], v[:, 25:], w[:, 25:], u, state0=mid)
    torch.testing.assert_close(torch.cat([a, b], dim=1), out, **WKV)
    torch.testing.assert_close(end, state, **WKV)


def test_cpu_route_takes_the_plain_version():
    reset_launch_counts()
    calls = rwkv6_plain.calls
    rwkv6(*map(T, operands(0, 1, 4, 2, 64, 64)))
    assert rwkv6_plain.calls == calls + 1
    assert launch_counts()["rwkv6"] == 0


def test_agreement_accepts_itself_and_rejects_planted_faults():
    r, k, v, w, u = map(T, operands(5, 2, 300, 2, 64, 64, w_mean=-6.0))
    out, state = rwkv6_plain(r, k, v, w, u)
    same = agreement(out.clone(), out)
    assert same["ok"] and same["worst"] == 0.0
    noisy = agreement(out * (1 + 1e-7), out)
    assert noisy["ok"] and noisy["worst"] > 0
    no_bonus, _ = rwkv6_plain(r, k, v, w, torch.zeros_like(u))
    assert not agreement(no_bonus, out)["ok"]
    _, short = rwkv6_plain(r[:, :-64], k[:, :-64], v[:, :-64], w[:, :-64], u)
    assert not agreement(short, state)["ok"]
    nan = out.clone()
    nan[0, 0, 0, 0] = float("nan")
    assert not agreement(nan, out)["ok"]


def test_wrapper_refuses_bad_operands():
    r, k, v, w, u = map(T, operands(1, 1, 4, 2, 16, 16))
    with pytest.raises(ShapeContractError):
        rwkv6(r, k, v, w, u[:1])
    with pytest.raises(ShapeContractError):
        rwkv6(r, k[:, :3], v, w, u)
    with pytest.raises(TypeError):
        rwkv6(r.double(), k, v, w, u)
    with pytest.raises(TypeError):
        rwkv6(r.to(torch.bfloat16), k, v, w, u)
    with pytest.raises(ShapeContractError):
        rwkv6(r, k, v, w, u, state0=torch.zeros((1, 2, 16, 16),
                                                dtype=torch.float64))
    # meta tensors take the dry-run's branch: shapes, no launch, no plain
    # version
    out, state = rwkv6(*(x.to("meta") for x in (r, k, v, w, u)))
    assert out.device.type == state.device.type == "meta"
    assert out.shape == (1, 4, 2, 16) and state.shape == (1, 2, 16, 16)
    assert out.dtype == state.dtype == torch.float32
