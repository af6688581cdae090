"""The port's MoE family held against the JAX package.

Both packages run reduced olmoe-1b-7b (``configs.reduced``: 2 layers, d 128,
4 heads with 4 KV heads, 4 experts top-2, expert width 128, router chunk
64, fp32) on the same weights: the JAX ``init_params`` tree goes through
numpy into ``params_from_numpy``.  Inputs are drawn with numpy from a
seed.  ``moe_ffn`` (out and aux), forward, prefill logits and caches and
chained decode steps are held to 1e-4 absolute and relative, the
tolerance of the dense model's tests (sums in another order: the
reference contracts a one-hot dispatch, the port gathers).  The routing
itself (expert picks, buffer slots, drops and the dense dispatch tensor)
is held exactly, the gates in the combine tensor to 1e-5 relative;
greedy tokens equal the JAX engine's, and paged decode is bit-equal to
the port's own one-shot loop."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import moe as j_moe
from repro.models import transformer as j_tr
from repro.serve import Engine as JEngine
from repro_torch.configs import get_config, reduced
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tr
from repro_torch.models.api import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Engine

MODEL = dict(atol=1e-4, rtol=1e-4)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def model():
    cfg = j_reduced(j_get_config("olmoe-1b-7b"))
    jp = j_tr.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def layer0(jp):
    return jax.tree.map(lambda a: a[0], jp["layers"])


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def jax_dispatch_combine(xc, params, cfg):
    """The dense dispatch and combine tensors, in the reference's own lines
    (``repro/models/moe.py``, one chunk)."""
    chunk = xc.shape[1]
    logits = xc @ params["router"]
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, cfg.top_k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True), 1e-9)
    cap = j_moe._capacity(chunk, cfg)
    onehot = jax.nn.one_hot(gate_idx, cfg.n_experts, dtype=jnp.int32)
    flat = onehot.reshape(xc.shape[0], -1, cfg.n_experts)
    pos = jnp.cumsum(flat, axis=1) * flat
    pos = pos.reshape(xc.shape[0], chunk, cfg.top_k, cfg.n_experts) - 1
    keep = (pos < cap) & (onehot > 0)
    cap_onehot = jax.nn.one_hot(jnp.where(keep, pos, -1), cap, dtype=xc.dtype)
    dispatch = cap_onehot.sum(2)
    combine = (cap_onehot * gate_vals.astype(xc.dtype)[..., None, None]).sum(2)
    return gate_idx, dispatch, combine


# ------------------------------------------------------------- the FFN
@pytest.mark.parametrize("b,t", [(2, 6), (1, 35), (2, 64), (1, 97), (2, 128)])
def test_moe_ffn_equals_jax(model, b, t):
    """Odd (35: one chunk of 35), prime (97: chunks of 1, capacity top_k)
    and two-chunk (128) lengths."""
    cfg, jp, tp = model
    x = rand(t, b, t, cfg.d_model)
    want, jaux = j_moe.moe_ffn(jnp.asarray(x), layer0(jp), cfg.moe)
    got, aux = t_moe.moe_ffn(T(x), tp.layers[0], cfg.moe)
    assert got.shape == (b, t, cfg.d_model) and aux.dtype == torch.float32
    np.testing.assert_allclose(N(got), N(want), **MODEL)
    np.testing.assert_allclose(float(aux), float(jaux), **MODEL)
    chunk = t_moe._chunk(t, cfg.moe)
    assert chunk == {6: 6, 35: 35, 64: 64, 97: 1, 128: 64}[t]
    assert t_moe._capacity(chunk, cfg.moe) == j_moe._capacity(chunk, cfg.moe)


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_routing_and_dispatch_equal_jax(model, factor):
    """The expert picks and the dense dispatch tensor rebuilt from the
    port's slots equal the reference's, and so does the combine tensor's
    support; its values, the gates, within 1e-5 relative (the two
    softmaxes round their last bits differently).  At capacity factor 0.5
    picks are dropped, and the FFN still agrees."""
    cfg, jp, tp = model
    mcfg = dataclasses.replace(cfg.moe, capacity_factor=factor)
    x = rand(40, 2, 48, cfg.d_model)
    params = layer0(jp)
    gate_idx, dispatch, combine = jax_dispatch_combine(jnp.asarray(x), params,
                                                       mcfg)
    r = t_moe.route(T(x), tp.layers[0]["router"], mcfg)
    np.testing.assert_array_equal(N(r.gate_idx), N(gate_idx))
    dt, ct = t_moe.dispatch_combine(r, torch.float32)
    np.testing.assert_array_equal(N(dt), N(dispatch))
    np.testing.assert_array_equal(N(ct) != 0, N(combine) != 0)
    np.testing.assert_allclose(N(ct), N(combine), rtol=1e-5, atol=0)
    if factor == 0.5:
        assert int((~r.kept).sum()) > 0.25 * r.kept.numel()   # many dropped
    want, jaux = j_moe.moe_ffn(jnp.asarray(x), params, mcfg)
    got, aux = t_moe.moe_ffn(T(x), tp.layers[0], mcfg)
    np.testing.assert_allclose(N(got), N(want), **MODEL)
    np.testing.assert_allclose(float(aux), float(jaux), **MODEL)


@pytest.mark.parametrize("tie", ["all", "pair"])
def test_equal_router_logits_pick_the_lower_expert(model, tie):
    """Equal probabilities pick the lower expert first, as
    ``jax.lax.top_k`` does."""
    cfg, jp, tp = model
    e, d = cfg.moe.n_experts, cfg.d_model
    router = np.zeros((d, e), np.float32)
    if tie == "pair":                    # experts 1 and 3 tie, above 0 and 2
        col = np.abs(rand(5, d))
        router[:, 1] = router[:, 3] = col
    x = np.abs(rand(6, 1, 10, d))
    params = dict(layer0(jp), router=jnp.asarray(router))
    gate_idx, _, _ = jax_dispatch_combine(jnp.asarray(x), params, cfg.moe)
    r = t_moe.route(T(x), T(router), cfg.moe)
    np.testing.assert_array_equal(N(r.gate_idx), N(gate_idx))
    want = [0, 1] if tie == "all" else [1, 3]
    assert (N(r.gate_idx) == want).all()
    lp = {k: tp.layers[0][k] for k in t_tr.MOE_LAYER_KEYS}
    lp["router"] = T(router)
    np.testing.assert_allclose(N(t_moe.moe_ffn(T(x), lp, cfg.moe)[0]),
                               N(j_moe.moe_ffn(jnp.asarray(x), params,
                                               cfg.moe)[0]), **MODEL)


# ------------------------------------------------------------ the model
def test_params_carry_and_init_shapes(model):
    cfg, jp, tp = model
    assert get_model(cfg) is t_tr
    for li, lp in enumerate(tp.layers):
        assert isinstance(lp, t_tr.MoELayer)
        for name in t_tr.MOE_LAYER_KEYS:
            np.testing.assert_array_equal(N(lp[name]),
                                          N(jp["layers"][name][li]))
    port = t_tr.init_params(reduced(get_config("olmoe-1b-7b")), 0,
                            device="cpu")
    assert ({n: tuple(p.shape) for n, p in port.named_parameters()}
            == {n: tuple(p.shape) for n, p in tp.named_parameters()})


@pytest.mark.parametrize("t", [1, 9, 67])
def test_forward_hidden_and_aux_equal_jax(model, t):
    cfg, jp, tp = model
    toks = np.random.default_rng(t).integers(0, cfg.vocab, (2, t))
    got, aux = t_tr.forward(cfg, tp, T(toks))
    want, jaux = j_tr.forward(cfg, jp, jnp.asarray(toks, jnp.int32))
    assert got.shape == want.shape == (2, t, cfg.d_model)
    np.testing.assert_allclose(N(got), N(want), **MODEL)
    np.testing.assert_allclose(float(aux), float(jaux), **MODEL)
    assert float(aux) > 0


def test_prefill_and_decode_steps_equal_jax(model):
    """Prefill logits and cache, then three contiguous decode steps fed
    JAX's own greedy token, and one paged step."""
    from repro.models import layers as j_layers
    from repro_torch.models import layers as t_layers

    cfg, jp, tp = model
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (2, 7))
    jl, jc = j_tr.prefill(cfg, jp, jnp.asarray(toks, jnp.int32))
    tl, tc = t_tr.prefill(cfg, tp, T(toks))
    np.testing.assert_allclose(N(tl), N(jl), **MODEL)
    np.testing.assert_allclose(N(tc.k), N(jc.k), **MODEL)
    np.testing.assert_allclose(N(tc.v), N(jc.v), **MODEL)
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

    rng = np.random.default_rng(12)
    shape = (cfg.n_layers, 7, 4, cfg.n_kv_heads, cfg.resolved_head_dim)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    tables, pos = np.array([[1, 2, 0], [3, 4, 5]]), np.array([5, 10])
    tok = rng.integers(0, cfg.vocab, (2, 1))
    jl, jpool = j_tr.decode_step_paged(
        cfg, jp, j_layers.PagedKVCache(k=jnp.asarray(kp), v=jnp.asarray(vp)),
        jnp.asarray(tables, jnp.int32), jnp.asarray(tok, jnp.int32),
        jnp.asarray(pos, jnp.int32))
    tl, tpool = t_tr.decode_step_paged(
        cfg, tp, t_layers.PagedKVCache(k=T(kp.copy()), v=T(vp.copy())),
        T(tables), T(tok), T(pos))
    np.testing.assert_allclose(N(tl), N(jl), **MODEL)
    np.testing.assert_allclose(N(tpool.k), N(jpool.k), **MODEL)


# -------------------------------------------------------------- serving
def test_generate_equals_jax_engine(model):
    cfg, jp, tp = model
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, (2, 6))
    want = JEngine(cfg, jp, block_size=4).generate(
        jnp.asarray(prompt, jnp.int32), 5)
    got = Engine(cfg, tp, device="cpu", block_size=4).generate(prompt, 5)
    assert got.shape == (2, 5) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("t", [3, 4, 5, 9])     # bs-1, bs, bs+1, 2bs+1
def test_paged_equals_legacy_across_block_boundaries(model, t):
    """JAX pins this for olmoe in tests/test_paging.py: the scheduler's
    paged tokens bit-equal to the one-shot loop over a static cache."""
    cfg, _, tp = model
    eng = Engine(cfg, tp, device="cpu", block_size=4)
    prompt = np.random.default_rng(t).integers(0, cfg.vocab, (1, t))
    np.testing.assert_array_equal(eng.generate(prompt, 6).numpy(),
                                  eng._generate_legacy(prompt, 6).numpy())
