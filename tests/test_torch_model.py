"""The port's layers and dense transformer held against the JAX package.

Both packages run reduced llama3.2-1b (``configs.reduced``: 2 layers,
d 128, 4 heads with 1 KV head, head_dim 32, fp32) on the same weights: the
JAX ``init_params`` tree goes through numpy into
``repro_torch.models.convert.params_from_numpy``.  Inputs are drawn with
numpy from a seed.  Layer-level tolerance is 2e-5 in fp32; whole-model
outputs are held to 1e-4 absolute and relative, because the sums run in
another order (JAX's chunked online-softmax scan against the port's plain
softmax, and two BLAS libraries)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import layers as j_layers
from repro.models import transformer as j_tr
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.models import layers as t_layers
from repro_torch.models import rwkv as t_rwkv
from repro_torch.models import transformer as t_tr
from repro_torch.models.api import get_model
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy

LAYER = dict(atol=2e-5, rtol=2e-5)
MODEL = dict(atol=1e-4, rtol=1e-4)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def model():
    cfg = j_reduced(j_get_config("llama3.2-1b"))
    jp = j_tr.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ layers
def test_rms_norm_equals_jax():
    x, s = rand(0, 2, 5, 128), rand(1, 128)
    np.testing.assert_allclose(N(t_layers.rms_norm(T(x), T(s), 1e-5)),
                               N(j_layers.rms_norm(x, s, 1e-5)), **LAYER)


@pytest.mark.parametrize("d,theta", [(32, 500000.0), (64, 10000.0)])
def test_apply_rope_equals_jax(d, theta):
    x = rand(d, 2, 7, 3, d)
    pos = np.random.default_rng(d).integers(0, 3000, (2, 7))
    np.testing.assert_allclose(N(t_layers.rope_freqs(d, theta)),
                               N(j_layers.rope_freqs(d, theta)), **LAYER)
    np.testing.assert_allclose(N(t_layers.apply_rope(T(x), T(pos), theta)),
                               N(j_layers.apply_rope(x, jnp.asarray(pos),
                                                     theta)), **LAYER)


def test_gqa_project_and_swiglu_equal_jax(model):
    cfg, jp, tp = model
    x = rand(3, 2, 6, cfg.d_model)
    pos = np.broadcast_to(np.arange(6), (2, 6))
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    got = t_layers.gqa_project(T(x), tp.layers[0], cfg, positions=T(pos))
    want = j_layers.gqa_project(x, jl, cfg, positions=jnp.asarray(pos))
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(N(g), N(w), **LAYER)
    lp = tp.layers[0]
    np.testing.assert_allclose(
        N(t_layers.swiglu(T(x), lp.w1, lp.w3, lp.w2)),
        N(j_layers.swiglu(x, jl["w1"], jl["w3"], jl["w2"])), **LAYER)


@pytest.mark.parametrize("pos", [0, 5, 11])
def test_decode_attention_equals_jax(pos):
    b, s, hq, hkv, d = 2, 12, 4, 2, 32
    q, kn, vn = rand(1, b, 1, hq, d), rand(2, b, 1, hkv, d), rand(3, b, 1, hkv, d)
    kc, vc = rand(4, b, s, hkv, d), rand(5, b, s, hkv, d)
    jc = j_layers.KVCache(k=jnp.asarray(kc), v=jnp.asarray(vc),
                          length=jnp.int32(pos))
    want, jnew = j_layers.decode_attention(q, jc, kn, vn, pos=jnp.int32(pos))
    tc = t_layers.KVCache(k=T(kc.copy()), v=T(vc.copy()), length=pos)
    got, tnew = t_layers.decode_attention(T(q), tc, T(kn), T(vn), pos=pos)
    np.testing.assert_allclose(N(got), N(want), **LAYER)
    np.testing.assert_array_equal(N(tnew.k), N(jnew.k))
    np.testing.assert_array_equal(N(tnew.v), N(jnew.v))
    assert tnew.length == pos + 1


def test_paged_decode_attention_equals_jax():
    b, nb, bs, hq, hkv, d = 3, 9, 4, 4, 2, 32
    q, kn, vn = rand(1, b, 1, hq, d), rand(2, b, 1, hkv, d), rand(3, b, 1, hkv, d)
    kp, vp = rand(4, nb, bs, hkv, d), rand(5, nb, bs, hkv, d)
    tables = np.array([[1, 4, 7], [2, 5, 0], [3, 0, 0]])
    pos = np.array([9, 6, 0])
    want, jk, jv = j_layers.paged_decode_attention(
        q, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables, jnp.int32),
        kn, vn, pos=jnp.asarray(pos, jnp.int32))
    got, tk, tv = t_layers.paged_decode_attention(
        T(q), T(kp.copy()), T(vp.copy()), T(tables), T(kn), T(vn), pos=T(pos))
    np.testing.assert_allclose(N(got), N(want), **LAYER)
    np.testing.assert_array_equal(N(tk), N(jk))
    np.testing.assert_array_equal(N(tv), N(jv))


# ------------------------------------------------------------------- model
def test_params_from_numpy_carries_every_weight(model):
    cfg, jp, tp = model
    assert len(tp.layers) == cfg.n_layers and tp.lm_head is None
    np.testing.assert_array_equal(N(tp.embed), N(jp["embed"]))
    np.testing.assert_array_equal(N(tp.final_norm), N(jp["final_norm"]))
    for li, lp in enumerate(tp.layers):
        for name in t_tr.LAYER_KEYS:
            np.testing.assert_array_equal(N(lp[name]),
                                          N(jp["layers"][name][li]))
    shapes = {n: tuple(p.shape) for n, p in tp.named_parameters()}
    port = t_tr.init_params(cfg, 0, device="cpu")
    assert {n: tuple(p.shape) for n, p in port.named_parameters()} == shapes
    assert not any(p.requires_grad for p in port.parameters())


def test_bf16_weights_cross_bit_for_bit():
    x = jax.random.normal(jax.random.PRNGKey(4), (5, 7), jnp.bfloat16)
    got = tensor_from_numpy(np.asarray(x), "cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(x).view(np.int16))
    cfg = get_config("llama3.2-1b")
    assert cfg.dtype == "bfloat16" and t_tr._dtype(cfg) == torch.bfloat16


@pytest.mark.parametrize("t", [1, 9, 40])
def test_forward_hidden_equals_jax(model, t):
    cfg, jp, tp = model
    toks = np.random.default_rng(t).integers(0, cfg.vocab, (2, t))
    got, aux = t_tr.forward(cfg, tp, T(toks))
    want, jaux = j_tr.forward(cfg, jp, jnp.asarray(toks, jnp.int32))
    assert got.shape == want.shape == (2, t, cfg.d_model)
    np.testing.assert_allclose(N(got), N(want), **MODEL)
    assert float(aux) == float(jaux) == 0.0


def test_forward_with_frontend_embeds_equals_jax(model):
    cfg, jp, tp = model
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (1, 6))
    emb = rand(9, 1, 3, cfg.d_model)
    got, _ = t_tr.forward(cfg, tp, T(toks), embeds=T(emb))
    want, _ = j_tr.forward(cfg, jp, jnp.asarray(toks, jnp.int32),
                           embeds=jnp.asarray(emb))
    np.testing.assert_allclose(N(got), N(want), **MODEL)


def test_prefill_and_decode_steps_equal_jax(model):
    """Prefill logits and cache, then three contiguous decode steps, each
    fed JAX's own greedy token so the two runs see the same inputs."""
    cfg, jp, tp = model
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (2, 7))
    jl, jc = j_tr.prefill(cfg, jp, jnp.asarray(toks, jnp.int32))
    tl, tc = t_tr.prefill(cfg, tp, T(toks))
    assert tl.shape == jl.shape == (2, 1, cfg.padded_vocab())
    np.testing.assert_allclose(N(tl), N(jl), **MODEL)
    np.testing.assert_allclose(N(tc.k), N(jc.k), **MODEL)
    np.testing.assert_allclose(N(tc.v), N(jc.v), **MODEL)
    assert tc.length == int(jc.length) == 7
    pad = [(0, 0), (0, 0), (0, 3), (0, 0), (0, 0)]
    jc = j_layers.KVCache(k=jnp.pad(jc.k, pad), v=jnp.pad(jc.v, pad),
                          length=jc.length)
    tc = t_layers.KVCache(k=T(np.pad(N(tc.k), pad)), v=T(np.pad(N(tc.v), pad)),
                          length=tc.length)
    for i in range(3):
        tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1))
        jl, jc = j_tr.decode_step(cfg, jp, jc, jnp.asarray(tok, jnp.int32),
                                  jnp.int32(7 + i))
        tl, tc = t_tr.decode_step(cfg, tp, tc, T(tok.astype(np.int64)), 7 + i)
        np.testing.assert_allclose(N(tl), N(jl), **MODEL)
    np.testing.assert_allclose(N(tc.k), N(jc.k), **MODEL)


def test_decode_step_paged_equals_jax(model):
    cfg, jp, tp = model
    nb, bs = 7, 4
    rng = np.random.default_rng(12)
    shape = (cfg.n_layers, nb, bs, cfg.n_kv_heads, cfg.resolved_head_dim)
    kp, vp = rng.standard_normal(shape), rng.standard_normal(shape)
    kp, vp = kp.astype(np.float32), vp.astype(np.float32)
    tables = np.array([[1, 2, 0], [3, 4, 5]])
    pos = np.array([5, 10])
    tok = rng.integers(0, cfg.vocab, (2, 1))
    jpool = j_layers.PagedKVCache(k=jnp.asarray(kp), v=jnp.asarray(vp))
    jl, jpool = j_tr.decode_step_paged(
        cfg, jp, jpool, jnp.asarray(tables, jnp.int32),
        jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32))
    tpool = t_layers.PagedKVCache(k=T(kp.copy()), v=T(vp.copy()))
    tl, tpool = t_tr.decode_step_paged(cfg, tp, tpool, T(tables), T(tok),
                                       T(pos))
    np.testing.assert_allclose(N(tl), N(jl), **MODEL)
    np.testing.assert_allclose(N(tpool.k), N(jpool.k), **MODEL)
    np.testing.assert_allclose(N(tpool.v), N(jpool.v), **MODEL)


def test_logits_mask_padded_vocab():
    cfg = reduced(get_config("llama3.2-1b"))
    import dataclasses

    cfg = dataclasses.replace(cfg, vocab=500)           # padded to 512
    tp = t_tr.init_params(cfg, 3, device="cpu")
    out = t_tr.logits_fn(cfg, tp, torch.ones(1, 1, cfg.d_model))
    assert out.shape == (1, 1, 512)
    assert bool((out[..., 500:] == -1e30).all())
    assert bool((out[..., :500] > -1e29).all())


# --------------------------------------------------------------- families
def test_get_model_ports_dense_and_vlm_only():
    """Every family maps to a module and none raises: dense, moe and vlm go
    through the transformer module, ssm through rwkv, hybrid through jamba
    and encdec through whisper (the name dates from when only dense and
    vlm were ported)."""
    from repro_torch.models import jamba as t_jamba
    from repro_torch.models import whisper as t_whisper

    modules = {"dense": t_tr, "moe": t_tr, "vlm": t_tr, "ssm": t_rwkv,
               "hybrid": t_jamba, "encdec": t_whisper}
    for name, cfg in ARCHS.items():
        assert get_model(cfg) is modules[cfg.family], name
    assert {cfg.family for cfg in ARCHS.values()} == set(modules)
    moe = reduced(get_config("olmoe-1b-7b"))
    tp = t_tr.init_params(moe, 0, device="cpu")
    assert all(isinstance(lp, t_tr.MoELayer) for lp in tp.layers)
    lp = tp.layers[0]
    e, f = moe.moe.n_experts, moe.moe.d_ff_expert
    assert lp["router"].shape == (moe.d_model, e)
    assert lp["moe_w1"].shape == lp["moe_w3"].shape == (e, moe.d_model, f)
    assert lp["moe_w2"].shape == (e, f, moe.d_model)
    hidden, aux = t_tr.forward(moe, tp, torch.ones((1, 5), dtype=torch.int64))
    assert hidden.shape == (1, 5, moe.d_model) and float(aux) > 0
