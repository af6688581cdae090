"""The port's RWKV-6 model and its serve route held against the JAX package.

Both packages run reduced rwkv6-1.6b (``configs.reduced``: 2 layers, d 128
= 2 heads of 64, ff 256, vocab 512, fp32) on the same weights: the JAX
``rwkv.init_params`` tree goes through numpy into
``repro_torch.models.convert.params_from_numpy``.  Inputs are drawn with
numpy from a seed.  The JAX model runs its WKV as ``rwkv6_chunked`` (the
config's ``wkv_chunk = 32``); the port runs ``kernels.rwkv6``, whose plain
version is the sequential recurrence.  Block-level outputs are held at
2e-5 and whole-model outputs at 1e-4, absolute and relative, because the
sums run in another order.  Greedy tokens are held equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import rwkv as j_rwkv
from repro.serve import Engine as JEngine
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.rwkv6 import rwkv6_plain
from repro_torch.models import rwkv as t_rwkv
from repro_torch.models.convert import params_from_numpy
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
    cfg = j_reduced(j_get_config("rwkv6-1.6b"))
    jp = j_rwkv.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def tokens(cfg, seed, b, t):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t))


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------- weights
def test_params_from_numpy_carries_every_weight(model):
    cfg, jp, tp = model
    assert isinstance(tp, t_rwkv.RWKV) and len(tp.layers) == cfg.n_layers
    for li, lp in enumerate(tp.layers):
        for name in t_rwkv.LAYER_KEYS:
            np.testing.assert_array_equal(N(lp[name]),
                                          np.asarray(jp["layers"][name][li]))
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(N(getattr(tp, name)), np.asarray(jp[name]))


def test_init_params_matches_the_jax_tree(model):
    cfg, jp, _ = model
    tp = t_rwkv.init_params(cfg, 3, device="cpu")
    for name in t_rwkv.LAYER_KEYS:
        want = jp["layers"][name]
        got = tp.layers[0][name]
        assert (len(tp.layers), *got.shape) == want.shape, name
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
    for name in ("embed", "final_norm", "lm_head"):
        assert tuple(getattr(tp, name).shape) == jp[name].shape
    # the fixed initial values, as the reference sets them
    assert bool((tp.layers[1]["w_base"] == -6.0).all())
    assert bool((tp.layers[1]["mu_g"] == 0.5).all())


def test_n_heads_needs_head_size_multiple():
    cfg = reduced(get_config("rwkv6-1.6b"))
    assert t_rwkv.n_heads(cfg) == 2
    import dataclasses

    with pytest.raises(ValueError, match="divisible by 64"):
        t_rwkv.n_heads(dataclasses.replace(cfg, d_model=96))


# ----------------------------------------------------------------- blocks
def test_time_mix_and_channel_mix_equal_jax(model):
    cfg, jp, tp = model
    x, prev = rand(1, 2, 9, cfg.d_model), rand(2, 2, cfg.d_model)
    jl = jax.tree.map(lambda a: a[1], jp["layers"])
    lp = tp.layers[1]
    out, last, state = t_rwkv._time_mix(cfg, T(x), T(prev), lp)
    j_out, j_last, j_state = j_rwkv._time_mix(cfg, x, prev, jl,
                                              return_state=True)
    np.testing.assert_allclose(N(out), N(j_out), **LAYER)
    np.testing.assert_allclose(N(last), N(j_last), **LAYER)
    np.testing.assert_allclose(N(state), N(j_state), **LAYER)
    cm, cm_last = t_rwkv._channel_mix(T(x), T(prev), lp)
    j_cm, j_cm_last = j_rwkv._channel_mix(x, prev, jl)
    np.testing.assert_allclose(N(cm), N(j_cm), **LAYER)
    np.testing.assert_allclose(N(cm_last), N(j_cm_last), **LAYER)


# ----------------------------------------------------------------- model
@pytest.mark.parametrize("b,t", [(2, 7), (1, 40)])   # 40: past one chunk
def test_forward_equals_jax(model, b, t):
    cfg, jp, tp = model
    tok = tokens(cfg, t, b, t)
    hidden, aux = t_rwkv.forward(cfg, tp, T(tok))
    j_hidden, j_aux = j_rwkv.forward(cfg, jp, jnp.asarray(tok))
    assert hidden.shape == (b, t, cfg.d_model)
    np.testing.assert_allclose(N(hidden), N(j_hidden), **MODEL)
    assert float(aux) == float(j_aux) == 0.0


@pytest.mark.parametrize("b,t", [(2, 5), (1, 37)])
def test_prefill_logits_and_cache_equal_jax(model, b, t):
    cfg, jp, tp = model
    tok = tokens(cfg, 100 + t, b, t)
    logits, cache = t_rwkv.prefill(cfg, tp, T(tok))
    j_logits, j_cache = j_rwkv.prefill(cfg, jp, jnp.asarray(tok))
    assert logits.shape == (b, 1, cfg.padded_vocab())
    np.testing.assert_allclose(N(logits), N(j_logits), **MODEL)
    for name in ("shift_tm", "shift_cm", "wkv"):
        got, want = getattr(cache, name), getattr(j_cache, name)
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(N(got), N(want), err_msg=name, **MODEL)
    assert cache.wkv.dtype == torch.float32
    assert cache.length == int(j_cache.length) == t


def test_three_chained_decode_steps_equal_jax(model):
    cfg, jp, tp = model
    tok = tokens(cfg, 5, 2, 6)
    _, cache = t_rwkv.prefill(cfg, tp, T(tok))
    _, j_cache = j_rwkv.prefill(cfg, jp, jnp.asarray(tok))
    step = tokens(cfg, 6, 2, 3)
    for i in range(3):
        nxt = step[:, i:i + 1]
        logits, cache = t_rwkv.decode_step(cfg, tp, cache, T(nxt), 6 + i)
        j_logits, j_cache = j_rwkv.decode_step(cfg, jp, j_cache,
                                               jnp.asarray(nxt), 6 + i)
        np.testing.assert_allclose(N(logits), N(j_logits), **MODEL)
        for name in ("shift_tm", "shift_cm", "wkv"):
            np.testing.assert_allclose(N(getattr(cache, name)),
                                       N(getattr(j_cache, name)),
                                       err_msg=f"step {i} {name}", **MODEL)
        assert cache.length == int(j_cache.length) == 7 + i


def test_decode_from_prefill_equals_a_longer_prefill(model):
    """The state prefill hands to decode is the one a longer prefill
    reaches: prefill T tokens + one decode step == prefill T + 1."""
    cfg, _, tp = model
    tok = T(tokens(cfg, 8, 2, 12))
    _, cache = t_rwkv.prefill(cfg, tp, tok[:, :-1])
    got, _ = t_rwkv.decode_step(cfg, tp, cache, tok[:, -1:], 11)
    want, _ = t_rwkv.prefill(cfg, tp, tok)
    np.testing.assert_allclose(N(got), N(want), **MODEL)
    _, cache = t_rwkv.prefill(cfg, tp, tok[:, :-1])
    cache.wkv.zero_()                   # a planted fault: decode forgets
    bad, _ = t_rwkv.decode_step(cfg, tp, cache, tok[:, -1:], 11)
    assert not np.allclose(N(bad), N(want), **MODEL)


def test_init_cache_is_zero_and_decodes_like_a_one_token_prefill(model):
    cfg, _, tp = model
    cache = t_rwkv.init_cache(cfg, 2, 64, device="cpu")
    assert cache.wkv.shape == (cfg.n_layers, 2, 2, 64, 64)
    assert cache.shift_tm.shape == (cfg.n_layers, 2, cfg.d_model)
    assert not cache.wkv.any() and cache.length == 0
    tok = T(tokens(cfg, 9, 2, 1))
    got, _ = t_rwkv.decode_step(cfg, tp, cache, tok, 0)
    want, _ = t_rwkv.prefill(cfg, tp, tok)
    np.testing.assert_allclose(N(got), N(want), **MODEL)


def test_prefill_runs_the_wkv_through_the_wrapper(model):
    cfg, _, tp = model
    reset_launch_counts()
    calls = rwkv6_plain.calls
    t_rwkv.prefill(cfg, tp, T(tokens(cfg, 1, 1, 4)))
    assert rwkv6_plain.calls == calls + cfg.n_layers    # the CPU route
    assert launch_counts()["rwkv6"] == 0


# ----------------------------------------------------------------- serve
def test_generate_equals_jax_engine(model):
    """The prompt of tests/test_serving.py's rwkv case."""
    cfg, jp, tp = model
    prompt = jax.random.randint(jax.random.PRNGKey(10), (2, 6), 0, cfg.vocab)
    want = JEngine(cfg, jp).generate(prompt, 4)
    eng = Engine(cfg, tp, device="cpu")
    assert not eng._paged
    got = eng.generate(np.array(prompt), 4)
    assert got.shape == (2, 4) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(eng.generate(np.array(prompt), 4).numpy(),
                                  got.numpy())


def test_generate_edges_max_new_0_and_1(model):
    cfg, _, tp = model
    eng = Engine(cfg, tp, device="cpu")
    prompt = tokens(cfg, 4, 3, 5)
    assert eng.generate(prompt, 0).shape == (3, 0)
    one = eng.generate(prompt, 1)
    logits, _ = t_rwkv.prefill(cfg, tp, T(prompt))
    np.testing.assert_array_equal(one.numpy(), logits[:, -1:].argmax(-1).numpy())


def test_scheduler_refuses_a_family_without_paged_decode(model):
    cfg, _, tp = model
    with pytest.raises(ValueError, match="no paged decode path"):
        ServeScheduler(cfg, tp, device="cpu")
    with pytest.raises(ValueError, match="no paged decode path"):
        Engine(cfg, tp, device="cpu").make_scheduler()


def test_pad_cache_passes_a_recurrent_cache_through(model):
    cfg, _, _ = model
    cache = t_rwkv.init_cache(cfg, 1, 8, device="cpu")
    assert _pad_cache(cache, 5) is cache
