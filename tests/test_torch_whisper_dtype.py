"""A bf16 whisper on fp32 frames: the port's dtypes and values against JAX's.

Reduced whisper-small (``configs.reduced``: 2 encoder and 2 decoder layers,
d 128, 4 heads of 32) with ``dtype="bfloat16"``: the JAX ``init_params``
tree (bf16 leaves) goes through numpy into ``params_from_numpy``.  Frames
are fp32 (or bf16) from a numpy seed, and 4 tokens.  JAX promotes bf16
weights against fp32 activations to fp32, so its encoder runs in fp32,
its decoder's cross-attention takes fp32 keys and values against bf16
queries, and a decode step turns fp32 once it has cross-attended.  The
port must give every output JAX's dtype, and values within 3e-2 absolute
and relative (bf16 rounds at other places in the two packages)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import whisper as j_whisper
from repro.serve.engine import _pad_cache as j_pad_cache
from repro_torch.models import whisper as t_whisper
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.serve.engine import _pad_cache

BF16 = dict(atol=3e-2, rtol=3e-2)
FRAMES = 12
TOKENS = 4


def T(x):
    return tensor_from_numpy(np.asarray(x), "cpu")


def N(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def dtype_name(x):
    return str(x.dtype).split(".")[-1]


def assert_like(got, want, what):
    assert dtype_name(got) == dtype_name(want), (what, got.dtype, want.dtype)
    assert tuple(got.shape) == tuple(want.shape), what
    assert np.isfinite(N(got)).all(), what
    np.testing.assert_allclose(N(got), N(want), err_msg=what, **BF16)


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(j_reduced(j_get_config("whisper-small")),
                              dtype="bfloat16")
    jp = j_whisper.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    assert tp.embed.dtype == torch.bfloat16
    return cfg, jp, tp


def inputs(cfg, frames_dtype):
    rng = np.random.default_rng(21)
    fr = rng.standard_normal((2, FRAMES, cfg.d_model)).astype(np.float32)
    tok = rng.integers(0, cfg.vocab, (2, TOKENS))
    nxt = rng.integers(0, cfg.vocab, (2, 2))
    j_fr = jnp.asarray(fr).astype(frames_dtype)
    return T(np.asarray(j_fr)), j_fr, tok, nxt


@pytest.mark.parametrize("frames_dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32 frames", "bf16 frames"])
def test_encode_forward_and_loss_follow_jax_dtypes(model, frames_dtype):
    cfg, jp, tp = model
    fr, j_fr, tok, _ = inputs(cfg, frames_dtype)
    enc = t_whisper.encode(cfg, tp, fr)
    j_enc = j_whisper.encode(cfg, jp, j_fr)
    assert_like(enc, j_enc, "encode")
    hidden, _ = t_whisper.forward(cfg, tp, torch.from_numpy(tok), embeds=fr)
    j_hidden, _ = j_whisper.forward(cfg, jp, jnp.asarray(tok), embeds=j_fr)
    assert dtype_name(j_hidden) == "bfloat16"
    assert_like(hidden, j_hidden, "forward")
    targets = np.roll(tok, -1, axis=1)
    loss = t_whisper.loss_fn(cfg, tp, torch.from_numpy(tok),
                             torch.from_numpy(targets), embeds=fr)
    j_loss = j_whisper.loss_fn(cfg, jp, jnp.asarray(tok), jnp.asarray(targets),
                               embeds=j_fr)
    assert_like(loss, j_loss, "loss_fn")


@pytest.mark.parametrize("frames_dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32 frames", "bf16 frames"])
def test_prefill_and_two_decode_steps_follow_jax_dtypes(model, frames_dtype):
    cfg, jp, tp = model
    fr, j_fr, tok, nxt = inputs(cfg, frames_dtype)
    logits, cache = t_whisper.prefill(cfg, tp, torch.from_numpy(tok), embeds=fr)
    j_logits, j_cache = j_whisper.prefill(cfg, jp, jnp.asarray(tok),
                                          embeds=j_fr)
    assert_like(logits, j_logits, "prefill logits")
    assert_like(cache.enc_out, j_cache.enc_out, "prefill enc_out")
    for l, (kv, jkv) in enumerate(zip(cache.self_kv, j_cache.self_kv,
                                      strict=True)):
        assert_like(kv.k, jkv.k, f"prefill k{l}")
        assert_like(kv.v, jkv.v, f"prefill v{l}")
    cache, j_cache = _pad_cache(cache, 2), j_pad_cache(j_cache, 2)
    for i in range(2):
        step = nxt[:, i:i + 1]
        logits, cache = t_whisper.decode_step(cfg, tp, cache,
                                              torch.from_numpy(step),
                                              TOKENS + i)
        j_logits, j_cache = j_whisper.decode_step(
            cfg, jp, j_cache, jnp.asarray(step), jnp.int32(TOKENS + i))
        assert_like(logits, j_logits, f"decode step {i}")
        for l, (kv, jkv) in enumerate(zip(cache.self_kv, j_cache.self_kv,
                                          strict=True)):
            assert_like(kv.k, jkv.k, f"step {i} k{l}")
            assert_like(kv.v, jkv.v, f"step {i} v{l}")


def test_init_cache_on_fp32_frames_follows_jax(model):
    """A cache built from an fp32 encoder output keeps it fp32, and decode
    from it agrees with JAX's."""
    cfg, jp, tp = model
    fr, j_fr, _, nxt = inputs(cfg, jnp.float32)
    enc = t_whisper.encode(cfg, tp, fr)
    j_enc = j_whisper.encode(cfg, jp, j_fr)
    cache = t_whisper.init_cache(cfg, 2, 3, enc, device="cpu")
    j_cache = j_whisper.init_cache(cfg, 2, 3, j_enc)
    assert_like(cache.enc_out, j_cache.enc_out, "init_cache enc_out")
    assert_like(cache.self_kv[0].k, j_cache.self_kv[0].k, "init_cache k0")
    for i in range(2):
        step = nxt[:, i:i + 1]
        logits, cache = t_whisper.decode_step(cfg, tp, cache,
                                              torch.from_numpy(step), i)
        j_logits, j_cache = j_whisper.decode_step(cfg, jp, j_cache,
                                                  jnp.asarray(step),
                                                  jnp.int32(i))
        assert_like(logits, j_logits, f"decode step {i} from init_cache")
