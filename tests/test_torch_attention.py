"""The port's attention held against the JAX package on the CPU.

On a CPU tensor ``repro_torch.kernels.flash_attention.flash_attention``
runs its plain version; it must agree with the Pallas kernel run as
``tests/test_kernels.py`` runs it (``interpret=True``), with
``ref.flash_attention_ref``, and with the models' ``attention_chunked`` and
``attention_direct``.  Inputs are drawn with numpy from a seed and handed
to both packages.  Tolerances are those of ``tests/test_kernels.py``:
2e-5 in fp32 (sums in another order), 3e-2 in bf16.  The CUDA kernel is
held against the plain version on the card in ``tests/test_torch_gpu.py``
and ``chip_smoke.py``, within ``flash_attention.agreement``'s tighter bf16
limits; the last test here shows what those limits pass and reject."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import layers as j_layers
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import (
    agreement,
    flash_attention,
    flash_attention_plain,
)
from repro_torch.models import layers as t_layers
from repro_torch.mpc.errors import ShapeContractError

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)

# the five shapes of tests/test_kernels.py::test_flash_attention_matches_oracle
SHAPES = [
    (1, 64, 64, 4, 4, 32, True),    # MHA causal
    (2, 128, 128, 8, 2, 16, True),  # GQA 4:1
    (1, 100, 100, 4, 1, 32, True),  # ragged T, MQA
    (1, 64, 64, 4, 4, 32, False),   # non-causal
    (2, 37, 37, 6, 3, 8, True),     # odd everything
]


def qkv(seed, b, t, s, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


def port(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def jaxed(*xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


@pytest.mark.parametrize("b,t,s,hq,hkv,d,causal", SHAPES)
def test_flash_equals_pallas_and_ref(b, t, s, hq, hkv, d, causal):
    q, k, v = qkv(b * 100 + t, b, t, s, hq, hkv, d)
    got = flash_attention(*port(q, k, v), causal=causal)
    assert got.shape == (b, t, hq, d) and got.dtype == torch.float32
    pallas = j_flash(*jaxed(q, k, v), causal=causal, bq=32, bk=32,
                     interpret=True)
    oracle = ref.flash_attention_ref(*jaxed(q, k, v), causal=causal)
    np.testing.assert_allclose(f32(got), f32(pallas), **F32)
    np.testing.assert_allclose(f32(got), f32(oracle), **F32)


def test_flash_bf16_equals_pallas_and_ref():
    q, k, v = qkv(0, 1, 64, 64, 4, 2, 32)
    got = flash_attention(*port(q, k, v, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    jq = jaxed(q, k, v, dtype=jnp.bfloat16)
    np.testing.assert_allclose(
        f32(got), f32(j_flash(*jq, bq=32, bk=32, interpret=True)), **BF16)
    np.testing.assert_allclose(
        f32(got), f32(ref.flash_attention_ref(*jq)), **BF16)


@pytest.mark.parametrize("b,t,s,hq,hkv,d,causal", SHAPES)
def test_attention_chunked_equals_jax(b, t, s, hq, hkv, d, causal):
    """The model's prefill attention: the port routes it to the flash
    wrapper; JAX computes it with an XLA online-softmax scan."""
    q, k, v = qkv(7 * t + d, b, t, s, hq, hkv, d)
    got = t_layers.attention_chunked(*port(q, k, v), causal=causal)
    want = j_layers.attention_chunked(*jaxed(q, k, v), causal=causal,
                                      q_chunk=32, kv_chunk=48)
    np.testing.assert_allclose(f32(got), f32(want), **F32)


@pytest.mark.parametrize("t,s,q_offset", [(16, 64, 48), (5, 37, 0),
                                          (24, 100, 60), (32, 32, 0)])
def test_flash_q_offset_equals_attention_direct(t, s, q_offset):
    """T != S: row i sits at q_offset + i, the models' semantics."""
    q, k, v = qkv(t + s, 2, t, s, 4, 2, 32)
    got = flash_attention(*port(q, k, v), causal=True, q_offset=q_offset)
    want = j_layers.attention_direct(*jaxed(q, k, v), causal=True,
                                     q_offset=q_offset)
    np.testing.assert_allclose(f32(got), f32(want), **F32)
    np.testing.assert_allclose(
        f32(t_layers.attention_direct(*port(q, k, v), causal=True,
                                      q_offset=q_offset)), f32(want), **F32)
    if q_offset == s - t:   # ref aligns its causal mask bottom-right
        np.testing.assert_allclose(
            f32(got), f32(ref.flash_attention_ref(*jaxed(q, k, v))), **F32)


def test_rows_that_see_no_key_are_zero():
    q, k, v = qkv(3, 1, 8, 8, 2, 1, 32)
    got = flash_attention(*port(q, k, v), causal=True, q_offset=-3)
    np.testing.assert_array_equal(got[:, :3].numpy(), 0.0)
    q, k, v = port(q, k, v)
    shifted = flash_attention(q[:, 3:], k, v, causal=True)   # rows at 0..4
    np.testing.assert_allclose(got[:, 3:].numpy(), shifted.numpy(), **F32)


def test_cpu_runs_the_plain_version_and_counts_it():
    q, k, v = port(*qkv(1, 1, 16, 16, 4, 2, 32))
    reset_launch_counts()
    before = flash_attention_plain.calls
    flash_attention(q, k, v)
    flash_attention(q, k, v, causal=False, scale=0.5)
    assert flash_attention_plain.calls == before + 2
    assert launch_counts()["flash_attention"] == 0
    torch.testing.assert_close(flash_attention(q, k, v, scale=0.5),
                               flash_attention_plain(q, k, v, scale=0.5))


def test_flash_refuses_bad_operands():
    q, k, v = port(*qkv(2, 1, 8, 8, 4, 2, 32))
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ShapeContractError):
        flash_attention(q, k[:, :, :1].repeat(1, 1, 3, 1),
                        v[:, :, :1].repeat(1, 1, 3, 1))   # 4 % 3 != 0
    with pytest.raises(ShapeContractError):
        flash_attention(q, k, v[:, :4])
    with pytest.raises(ShapeContractError):
        flash_attention(q[0], k[0], v[0])


def p_rounded_attention(q, k, v, causal):
    """Attention rounded as the CUDA kernel's bf16 path rounds it: fp32
    scores and softmax statistics, P rounded to bf16 for the P V product,
    the output rounded to bf16."""
    group = q.shape[2] // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(group, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(group, dim=2).transpose(1, 2)
    s = qf @ kf.transpose(-1, -2) * q.shape[3] ** -0.5
    if causal:
        s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool).tril(),
                          float("-inf"))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = (e.bfloat16().float() @ vf) / e.sum(-1, keepdim=True)
    return o.transpose(1, 2).bfloat16()


@pytest.mark.parametrize("b,t,hq,hkv,d,causal", [
    (1, 64, 4, 2, 32, True), (1, 256, 8, 2, 64, True),
    (2, 128, 4, 1, 64, False), (1, 200, 4, 1, 128, True)])
def test_bf16_agreement_passes_rounding_and_rejects_planted_faults(
        b, t, hq, hkv, d, causal):
    """The kernel's bf16 check: the Pallas kernel's bf16 output and an
    output with the CUDA kernel's own rounding pass it; the softmax scale
    off by 1 %, the last tile of rows without the last 32 keys, and a NaN
    fail it."""
    q, k, v = qkv(t + d, b, t, t, hq, hkv, d)
    tq, tk, tv = port(q, k, v, dtype=torch.bfloat16)
    want = flash_attention_plain(tq, tk, tv, causal=causal)
    pallas = j_flash(*jaxed(q, k, v, dtype=jnp.bfloat16), causal=causal,
                     bq=32, bk=32, interpret=True)
    pallas = torch.from_numpy(f32(pallas)).bfloat16()
    assert agreement(pallas, want)["ok"], agreement(pallas, want)
    rounded = p_rounded_attention(tq, tk, tv, causal)
    assert agreement(rounded, want)["ok"], agreement(rounded, want)

    scaled = flash_attention_plain(tq, tk, tv, causal=causal,
                                   scale=1.01 * d ** -0.5)
    tile = 32
    tail = flash_attention_plain(tq[:, t - tile:], tk[:, :t - tile],
                                 tv[:, :t - tile], causal=causal,
                                 q_offset=t - tile)
    dropped = torch.cat([want[:, :t - tile], tail], dim=1)
    nan = want.clone()
    nan[0, -1, 0, 0] = float("nan")
    for bad in (scaled, dropped, nan):
        assert not agreement(bad, want)["ok"], agreement(bad, want)
