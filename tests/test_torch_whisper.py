"""The port's Whisper encoder–decoder and its serve route held against the
JAX package.

Both packages run reduced whisper-small (``configs.reduced``: 2 encoder and
2 decoder layers, d 128, 4 heads of 32, ff 256, vocab 512, fp32) on the
same weights: the JAX ``init_params`` tree goes through numpy into
``params_from_numpy``.  Frames and tokens are drawn with numpy from a
seed.  Block outputs are held at 2e-5, whole-model outputs, caches and
chained decode steps at 1e-4, absolute and relative (sums in another
order).  The port's engine decodes at positions ``T + i`` of the self-KV
cache; its tokens are held equal to a loop of JAX's own ``decode_step``
at those positions (the JAX engine counts the encoder frames into the
decode position too: ROADMAP §3)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import whisper as j_whisper
from repro.serve.engine import _pad_cache as j_pad_cache
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import whisper as t_whisper
from repro_torch.models.api import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.mpc.errors import ShapeContractError
from repro_torch.serve import Engine, ServeScheduler
from repro_torch.serve.engine import _pad_cache

LAYER = dict(atol=2e-5, rtol=2e-5)
MODEL = dict(atol=1e-4, rtol=1e-4)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def model():
    cfg = j_reduced(j_get_config("whisper-small"))
    jp = j_whisper.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def tokens(cfg, seed, b, t):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t))


def frames(cfg, seed, b, s):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def assert_cache_close(cache, j_cache, what=""):
    for l, (kv, jkv) in enumerate(zip(cache.self_kv, j_cache.self_kv,
                                      strict=True)):
        np.testing.assert_allclose(N(kv.k), N(jkv.k), err_msg=f"{what} k{l}",
                                   **MODEL)
        np.testing.assert_allclose(N(kv.v), N(jkv.v), err_msg=f"{what} v{l}",
                                   **MODEL)
    np.testing.assert_allclose(N(cache.enc_out), N(j_cache.enc_out), **MODEL)
    assert cache.length == int(j_cache.length)


# ---------------------------------------------------------------- weights
def test_params_from_numpy_carries_every_weight(model):
    cfg, jp, tp = model
    assert isinstance(tp, t_whisper.Whisper) and get_model(cfg) is t_whisper
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, want in flat:
        node = tp
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        np.testing.assert_array_equal(N(node), np.asarray(want), err_msg=str(path))
    assert len(list(tp.parameters())) == len(flat)


def test_init_params_matches_the_jax_tree(model):
    cfg, jp, _ = model
    tp = t_whisper.init_params(cfg, 3, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, want in flat:
        node = tp
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        assert tuple(node.shape) == want.shape, path
        assert node.dtype == torch.float32
    assert torch.equal(tp.dec_layers[1]["norm3"]["scale"], torch.ones(cfg.d_model))
    assert not tp.enc_norm["bias"].any()


# ----------------------------------------------------------------- parts
def test_layer_norm_and_sinusoids_equal_jax():
    rng = np.random.default_rng(0)
    x, s, b = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((2, 5, 64), (64,), (64,)))
    np.testing.assert_allclose(
        N(t_whisper.layer_norm(T(x), T(s), T(b), 1e-5)),
        N(j_whisper.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                               1e-5)), **LAYER)
    got = t_whisper.sinusoids(1500, 768)
    assert got.shape == (1500, 768) and got.dtype == torch.float32
    np.testing.assert_allclose(N(got), np.asarray(j_whisper.sinusoids(1500, 768),
                                                  dtype=np.float32),
                               rtol=0, atol=1e-6)


def test_mlp_is_the_tanh_gelu(model):
    """``jax.nn.gelu`` is the tanh approximation; torch's default, the erf
    form, must fail the same check."""
    _, jp, tp = model
    x = np.random.default_rng(1).standard_normal((2, 7, 128)).astype(
        np.float32) * 2
    p, jl = tp.enc_layers[0], jp["enc_layers"][0]
    want = N(j_whisper._mlp(jnp.asarray(x), jl))
    np.testing.assert_allclose(N(t_whisper._mlp(T(x), p)), want, **LAYER)
    erf = F.gelu(T(x) @ p["w1"]) @ p["w2"]
    assert not np.allclose(N(erf), want, **LAYER)


def test_mha_equals_jax(model):
    cfg, jp, tp = model
    x, kv = frames(cfg, 2, 2, 6), frames(cfg, 3, 2, 11)
    p, jl = tp.dec_layers[0], jp["dec_layers"][0]
    for causal, src, prefix, direct in ((True, None, "", False),
                                        (False, kv, "x_", False),
                                        (False, kv, "x_", True)):
        got = t_whisper._mha(cfg, T(x), p, None if src is None else T(src),
                             causal=causal, prefix=prefix, direct=direct)
        want = j_whisper._mha(cfg, jnp.asarray(x), jl,
                              None if src is None else jnp.asarray(src),
                              causal=causal, prefix=prefix, direct=direct)
        np.testing.assert_allclose(N(got), N(want), **LAYER)


# ----------------------------------------------------------------- model
@pytest.mark.parametrize("b,t,s", [(2, 5, 12), (1, 9, 30)])
def test_encode_and_forward_equal_jax(model, b, t, s):
    cfg, jp, tp = model
    fr, tok = frames(cfg, s, b, s), tokens(cfg, t, b, t)
    np.testing.assert_allclose(N(t_whisper.encode(cfg, tp, T(fr))),
                               N(j_whisper.encode(cfg, jp, jnp.asarray(fr))),
                               **MODEL)
    hidden, aux = t_whisper.forward(cfg, tp, T(tok), embeds=T(fr))
    j_hidden, j_aux = j_whisper.forward(cfg, jp, jnp.asarray(tok),
                                        embeds=jnp.asarray(fr))
    assert hidden.shape == (b, t, cfg.d_model)
    np.testing.assert_allclose(N(hidden), N(j_hidden), **MODEL)
    assert float(aux) == float(j_aux) == 0.0
    with pytest.raises(ShapeContractError, match="frame embeddings"):
        t_whisper.forward(cfg, tp, T(tok))
    with pytest.raises(ShapeContractError, match="frame embeddings"):
        t_whisper.prefill(cfg, tp, T(tok))


def test_prefill_and_chained_decode_steps_equal_jax(model):
    cfg, jp, tp = model
    fr, tok = frames(cfg, 4, 2, 12), tokens(cfg, 5, 2, 4)
    logits, cache = t_whisper.prefill(cfg, tp, T(tok), embeds=T(fr))
    j_logits, j_cache = j_whisper.prefill(cfg, jp, jnp.asarray(tok),
                                          embeds=jnp.asarray(fr))
    assert logits.shape == (2, 1, cfg.padded_vocab())
    np.testing.assert_allclose(N(logits), N(j_logits), **MODEL)
    assert_cache_close(cache, j_cache, "prefill")
    cache, j_cache = _pad_cache(cache, 3), j_pad_cache(j_cache, 3)
    step = tokens(cfg, 6, 2, 3)
    for i in range(3):
        nxt = step[:, i:i + 1]
        logits, cache = t_whisper.decode_step(cfg, tp, cache, T(nxt), 4 + i)
        j_logits, j_cache = j_whisper.decode_step(cfg, jp, j_cache,
                                                  jnp.asarray(nxt),
                                                  jnp.int32(4 + i))
        np.testing.assert_allclose(N(logits), N(j_logits), **MODEL)
        assert_cache_close(cache, j_cache, f"step {i}")


def test_init_cache_and_decode_from_it_equal_jax(model):
    cfg, jp, tp = model
    cache = t_whisper.init_cache(cfg, 2, 5, device="cpu")
    j_cache = j_whisper.init_cache(cfg, 2, 5)
    assert cache.enc_out.shape == (2, 5, cfg.d_model) and not cache.enc_out.any()
    assert_cache_close(cache, j_cache, "init")
    enc = frames(cfg, 7, 2, 8)
    cache = t_whisper.init_cache(cfg, 2, 5, T(enc), device="cpu")
    j_cache = j_whisper.init_cache(cfg, 2, 5, jnp.asarray(enc))
    step = tokens(cfg, 8, 2, 3)
    for i in range(3):
        logits, cache = t_whisper.decode_step(cfg, tp, cache, T(step[:, i:i + 1]),
                                              i)
        j_logits, j_cache = j_whisper.decode_step(
            cfg, jp, j_cache, jnp.asarray(step[:, i:i + 1]), jnp.int32(i))
        np.testing.assert_allclose(N(logits), N(j_logits), **MODEL)


def test_decode_from_prefill_equals_a_longer_prefill(model):
    cfg, _, tp = model
    fr, tok = T(frames(cfg, 9, 2, 10)), T(tokens(cfg, 9, 2, 7))
    want, _ = t_whisper.prefill(cfg, tp, tok, embeds=fr)
    _, cache = t_whisper.prefill(cfg, tp, tok[:, :-1], embeds=fr)
    got, _ = t_whisper.decode_step(cfg, tp, _pad_cache(cache, 1), tok[:, -1:], 6)
    np.testing.assert_allclose(N(got), N(want), **MODEL)


def test_prefill_runs_every_attention_but_decode_cross_through_flash(model):
    cfg, _, tp = model
    reset_launch_counts()
    calls = flash_attention_plain.calls
    _, cache = t_whisper.prefill(cfg, tp, T(tokens(cfg, 1, 1, 4)),
                                 embeds=T(frames(cfg, 1, 1, 6)))
    assert flash_attention_plain.calls == calls + 2 + 2 * 2   # the CPU route
    t_whisper.decode_step(cfg, tp, _pad_cache(cache, 1),
                          T(tokens(cfg, 2, 1, 1)), 4)
    assert flash_attention_plain.calls == calls + 6
    assert launch_counts()["flash_attention"] == 0


# ----------------------------------------------------------------- serve
def test_pad_cache_grows_the_self_kv_only(model):
    cfg, _, tp = model
    _, cache = t_whisper.prefill(cfg, tp, T(tokens(cfg, 3, 2, 4)),
                                 embeds=T(frames(cfg, 3, 2, 9)))
    grown = _pad_cache(cache, 5)
    for kv, old in zip(grown.self_kv, cache.self_kv, strict=True):
        assert kv.k.shape[1] == kv.v.shape[1] == 9
        assert torch.equal(kv.k[:, :4], old.k) and not kv.k[:, 4:].any()
    assert grown.enc_out is cache.enc_out and grown.length == 4


@pytest.mark.parametrize("b,t,s,n", [(2, 4, 12, 6), (1, 7, 20, 4)])
def test_generate_equals_a_jax_decode_step_loop_at_t_plus_i(model, b, t, s, n):
    cfg, jp, tp = model
    fr, tok = frames(cfg, 10 + s, b, s), tokens(cfg, 10 + t, b, t)
    eng = Engine(cfg, tp, device="cpu")
    assert not eng._paged
    got = eng.generate(tok, n, embeds=T(fr))
    assert got.shape == (b, n) and got.dtype == torch.int64
    logits, cache = j_whisper.prefill(cfg, jp, jnp.asarray(tok),
                                      embeds=jnp.asarray(fr))
    cache = j_pad_cache(cache, n - 1)
    nxt = jnp.argmax(logits[:, -1:], axis=-1)
    want = [nxt]
    for i in range(n - 1):
        logits, cache = j_whisper.decode_step(cfg, jp, cache, nxt,
                                              jnp.int32(t + i))
        nxt = jnp.argmax(logits[:, -1:], axis=-1)
        want.append(nxt)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.concatenate(want, axis=1)))


def test_scheduler_refuses_the_encdec_family(model):
    cfg, _, tp = model
    with pytest.raises(ValueError, match="no paged decode path"):
        ServeScheduler(cfg, tp, device="cpu")


def test_port_config_is_the_reference_config():
    cfg = reduced(get_config("whisper-small"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        j_reduced(j_get_config("whisper-small")))
