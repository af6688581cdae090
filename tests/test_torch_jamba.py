"""The port's Jamba hybrid and its serve route held against the JAX package.

Both packages run reduced jamba-v0.1-52b (``configs.reduced``: 8 layers,
one period of the 1:7 interleave with attention at layer 4 and MoE on the
odd layers; d 128, 4 heads with 1 KV head of 32, 4 experts top-2, Mamba
Di 256, N 8, chunk 16, fp32) on the same weights: the JAX ``init_params``
tree goes through numpy into ``params_from_numpy``.  Inputs are drawn with
numpy from a seed.  Whole-model outputs, caches and chained decode steps
are held at 1e-4 absolute and relative (sums in another order: the port's
attention is the flash kernel's plain version, its scan the plain
version's tree); greedy tokens are held equal to the JAX engine's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import jamba as j_jamba
from repro.serve import Engine as JEngine
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.selective_scan import selective_scan_plain
from repro_torch.models import jamba as t_jamba
from repro_torch.models import ssm as t_ssm
from repro_torch.models.api import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import KVCache
from repro_torch.serve import Engine, ServeScheduler
from repro_torch.serve.engine import _pad_cache

MODEL = dict(atol=1e-4, rtol=1e-4)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def model():
    cfg = j_reduced(j_get_config("jamba-v0.1-52b"))
    jp = j_jamba.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def tokens(cfg, seed, b, t):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t))


def assert_cache_close(cache, j_cache, what=""):
    for l, (kv, jkv) in enumerate(zip(cache.kv, j_cache.kv, strict=True)):
        assert (kv is None) == (jkv is None), l
        if kv is not None:
            np.testing.assert_allclose(N(kv.k), N(jkv.k), err_msg=f"{what} k{l}",
                                       **MODEL)
            np.testing.assert_allclose(N(kv.v), N(jkv.v), err_msg=f"{what} v{l}",
                                       **MODEL)
    for name in ("conv", "ssm"):
        for l, (x, jx) in enumerate(zip(getattr(cache, name),
                                        getattr(j_cache, name), strict=True)):
            assert (x is None) == (jx is None), (name, l)
            if x is not None:
                assert tuple(x.shape) == jx.shape
                np.testing.assert_allclose(N(x), N(jx),
                                           err_msg=f"{what} {name}{l}", **MODEL)
    assert cache.length == int(j_cache.length)


# ---------------------------------------------------------------- weights
def test_layer_pattern_is_one_period_of_the_interleave(model):
    cfg, _, _ = model
    assert cfg.n_layers == 8 and get_model(cfg) is t_jamba
    assert [l for l in range(8) if t_jamba.is_attn_layer(cfg, l)] == [4]
    assert [l for l in range(8) if t_jamba.is_moe_layer(cfg, l)] == [1, 3, 5, 7]
    for l in range(8):
        assert t_jamba.is_attn_layer(cfg, l) == j_jamba.is_attn_layer(cfg, l)
        assert t_jamba.is_moe_layer(cfg, l) == j_jamba.is_moe_layer(cfg, l)


def test_params_from_numpy_carries_every_weight(model):
    cfg, jp, tp = model
    assert isinstance(tp, t_jamba.Jamba) and len(tp.layers) == cfg.n_layers
    for l, (lp, jl) in enumerate(zip(tp.layers, jp["layers"], strict=True)):
        for name, want in jl.items():
            if name == "mamba":
                assert isinstance(lp["mamba"], t_ssm.Mamba)
                for key, w in want.items():
                    np.testing.assert_array_equal(N(lp["mamba"][key]),
                                                  np.asarray(w))
            else:
                np.testing.assert_array_equal(N(lp[name]), np.asarray(want),
                                              err_msg=f"{l} {name}")
        assert isinstance(getattr(lp, "mamba", None), t_ssm.Mamba) == (
            "mamba" in jl), l
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(N(tp[name]), np.asarray(jp[name]))


def test_init_params_matches_the_jax_tree(model):
    cfg, jp, _ = model
    tp = t_jamba.init_params(cfg, 3, device="cpu")
    for lp, jl in zip(tp.layers, jp["layers"], strict=True):
        names = {n for n, _ in lp.named_parameters()}
        want = {f"mamba.{k}" if n == "mamba" else n
                for n, v in jl.items() for k in (v if n == "mamba" else [n])}
        assert names == want
        for n, v in lp.named_parameters():
            j = jl["mamba"][n[6:]] if n.startswith("mamba.") else jl[n]
            assert tuple(v.shape) == j.shape and v.dtype == torch.float32, n
    for name in ("embed", "final_norm", "lm_head"):
        assert tuple(tp[name].shape) == jp[name].shape
    bf = t_jamba.init_params(dataclasses.replace(cfg, dtype="bfloat16"), 3,
                             device="cpu")
    assert {p.dtype for p in bf.parameters()} == {torch.bfloat16}


# ----------------------------------------------------------------- model
@pytest.mark.parametrize("b,t", [(2, 9), (1, 37), (2, 70)])   # 70: > chunk
def test_forward_hidden_and_aux_equal_jax(model, b, t):         # and router
    cfg, jp, tp = model
    tok = tokens(cfg, t, b, t)
    hidden, aux = t_jamba.forward(cfg, tp, T(tok))
    j_hidden, j_aux = j_jamba.forward(cfg, jp, jnp.asarray(tok))
    assert hidden.shape == (b, t, cfg.d_model)
    np.testing.assert_allclose(N(hidden), N(j_hidden), **MODEL)
    np.testing.assert_allclose(float(aux), float(j_aux), **MODEL)
    assert float(aux) > 0


@pytest.mark.parametrize("b,t", [(2, 5), (1, 33)])
def test_prefill_logits_and_every_cache_entry_equal_jax(model, b, t):
    cfg, jp, tp = model
    tok = tokens(cfg, 100 + t, b, t)
    logits, cache = t_jamba.prefill(cfg, tp, T(tok))
    j_logits, j_cache = j_jamba.prefill(cfg, jp, jnp.asarray(tok))
    assert logits.shape == (b, 1, cfg.padded_vocab())
    np.testing.assert_allclose(N(logits), N(j_logits), **MODEL)
    assert_cache_close(cache, j_cache)
    assert cache.length == t


def test_chained_decode_steps_equal_jax(model):
    cfg, jp, tp = model
    tok = tokens(cfg, 5, 2, 6)
    _, cache = t_jamba.prefill(cfg, tp, T(tok))
    _, j_cache = j_jamba.prefill(cfg, jp, jnp.asarray(tok))
    from repro.serve.engine import _pad_cache as j_pad_cache

    cache, j_cache = _pad_cache(cache, 3), j_pad_cache(j_cache, 3)
    step = tokens(cfg, 6, 2, 3)
    for i in range(3):
        nxt = step[:, i:i + 1]
        logits, cache = t_jamba.decode_step(cfg, tp, cache, T(nxt), 6 + i)
        j_logits, j_cache = j_jamba.decode_step(cfg, jp, j_cache,
                                                jnp.asarray(nxt),
                                                jnp.int32(6 + i))
        np.testing.assert_allclose(N(logits), N(j_logits), **MODEL)
        assert_cache_close(cache, j_cache, f"step {i}")


def test_windowed_slot_past_a_small_max_len_equals_jax(model):
    """Decoding past the window writes the last slot, as ``min(pos,
    win - 1)`` does in the reference."""
    cfg, jp, tp = model
    cache = t_jamba.init_cache(cfg, 2, 3, device="cpu")
    j_cache = j_jamba.init_cache(cfg, 2, 3)
    assert cache.kv[4].k.shape == (2, 3, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert_cache_close(cache, j_cache, "init")
    step = tokens(cfg, 7, 2, 6)
    for i in range(6):                       # positions 3, 4, 5 pass the window
        nxt = step[:, i:i + 1]
        logits, cache = t_jamba.decode_step(cfg, tp, cache, T(nxt), i)
        j_logits, j_cache = j_jamba.decode_step(cfg, jp, j_cache,
                                                jnp.asarray(nxt), jnp.int32(i))
        np.testing.assert_allclose(N(logits), N(j_logits), **MODEL)
        assert_cache_close(cache, j_cache, f"step {i}")
    assert cache.kv[4].k.shape[1] == 3


def test_decode_from_prefill_equals_a_longer_prefill(model):
    """prefill T - 1 tokens + one decode step == prefill T; zeroed Mamba
    states fail the same check.  The MoE layers run with a capacity that
    keeps every pick (``capacity_factor = E / k``): at the config's 1.25 a
    prefill may drop the last token's pick at a full expert, which a
    one-token decode step never does, and that is the routing's contract,
    not the state handed to decode."""
    cfg, _, tp = model
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    tok = T(tokens(cfg, 8, 2, 21))
    want, _ = t_jamba.prefill(cfg, tp, tok)
    _, cache = t_jamba.prefill(cfg, tp, tok[:, :-1])
    got, _ = t_jamba.decode_step(cfg, tp, _pad_cache(cache, 1), tok[:, -1:], 20)
    np.testing.assert_allclose(N(got), N(want), **MODEL)
    _, cache = t_jamba.prefill(cfg, tp, tok[:, :-1])
    for x in cache.conv + cache.ssm:
        if x is not None:
            x.zero_()
    bad, _ = t_jamba.decode_step(cfg, tp, _pad_cache(cache, 1), tok[:, -1:], 20)
    assert not np.allclose(N(bad), N(want), **MODEL)


def test_prefill_runs_the_scan_and_attention_through_the_wrappers(model):
    cfg, _, tp = model
    reset_launch_counts()
    scans, flashes = selective_scan_plain.calls, flash_attention_plain.calls
    t_jamba.prefill(cfg, tp, T(tokens(cfg, 1, 1, 4)))
    assert selective_scan_plain.calls == scans + 7       # the CPU routes
    assert flash_attention_plain.calls == flashes + 1
    assert launch_counts()["selective_scan"] == 0
    assert launch_counts()["flash_attention"] == 0


# ----------------------------------------------------------------- serve
def test_pad_cache_grows_only_the_attention_layer(model):
    cfg, _, tp = model
    _, cache = t_jamba.prefill(cfg, tp, T(tokens(cfg, 2, 2, 5)))
    grown = _pad_cache(cache, 4)
    assert isinstance(grown.kv[4], KVCache)
    assert grown.kv[4].k.shape[1] == grown.kv[4].v.shape[1] == 9
    assert torch.equal(grown.kv[4].k[:, :5], cache.kv[4].k)
    assert not grown.kv[4].k[:, 5:].any()
    assert all(a is b for a, b in zip(grown.conv, cache.conv, strict=True))
    assert all(a is b for a, b in zip(grown.ssm, cache.ssm, strict=True))
    assert grown.length == cache.length == 5


@pytest.mark.parametrize("b,t,n", [(2, 6, 5), (1, 20, 3)])
def test_generate_equals_jax_engine(model, b, t, n):
    cfg, jp, tp = model
    prompt = jax.random.randint(jax.random.PRNGKey(10 + t), (b, t), 0,
                                cfg.vocab)
    want = JEngine(cfg, jp).generate(prompt, n)
    eng = Engine(cfg, tp, device="cpu")
    assert not eng._paged
    got = eng.generate(np.array(prompt), n)
    assert got.shape == (b, n) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scheduler_refuses_the_hybrid_family(model):
    cfg, _, tp = model
    with pytest.raises(ValueError, match="no paged decode path"):
        ServeScheduler(cfg, tp, device="cpu")


def test_port_config_is_the_reference_config():
    cfg = reduced(get_config("jamba-v0.1-52b"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        j_reduced(j_get_config("jamba-v0.1-52b")))
