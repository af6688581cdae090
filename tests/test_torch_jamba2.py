"""The published Jamba mixer (AI21-Jamba2-3B's form) in ``repro_torch``
against the benchmark's plain reference, on the CPU.

A tiny configuration keeps what makes the model: 20 query heads over one
kv head, one attention layer at offset 7 among 14 layers (13 Mamba
mixers), Δ at rank ``d / 16`` with Jamba's RMS norms of Δ, B and C, no
RoPE and the tied head.  In float32 on seeded weights the program's loss
equals ``portbench/references/jamba2.py``'s within 1e-6 and every
gradient within 1e-5 in relative Frobenius norm (the north star's
training tolerance: the two sum in another order, and the scans and the
attention differ in form), with and without ``remat``; the reference's
scan chunks and attention blocks are cut small here so that its carries
across them are exercised.  Each of the three norms acts on its slice of
``x_proj``.  Prefill then decode through the caches equal
the full forward's logits, and a decode from zeroed states does not.
The default path (rank-one Δ, RoPE, untied head) keeps its key set and is
held against JAX by ``test_torch_jamba.py`` and ``test_torch_ssm.py``.
"""
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from portbench.kinds.train_jamba import model_config
from portbench.references import jamba2 as ref
from repro_torch.configs import get_config, reduced
from repro_torch.models import jamba, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import KVCache

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 33 + 7
B, T = 2, 32
TINY = {"hidden_size": 160, "intermediate_size": 256, "vocab_size": 512,
        "mamba_dt_rank": 10, "dtype": "float32", "remat": False,
        "num_hidden_layers": 14}


def tiny(**over) -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs" / "jamba2-3b.json")
                     .read_text())
    cfg.update(TINY, **over)
    return cfg


def _tokens(cfg, t=T):
    g = torch.Generator().manual_seed(11)
    toks = torch.randint(0, cfg["vocab_size"], (B, t + 1), generator=g)
    return toks[:, :-1], toks[:, 1:]


def test_tiny_config_keeps_the_published_form():
    cfg = tiny()
    mc = model_config(cfg)
    assert [l for l in range(mc.n_layers) if jamba.is_attn_layer(mc, l)] == [7]
    assert mc.n_heads // mc.n_kv_heads == 20
    assert mc.ssm.dt_rank == mc.d_model // 16
    assert not mc.attn_rope and mc.tie_embeddings
    params = jamba.build(mc, ref.initial_weights(cfg, SEED, "cpu"))
    assert not hasattr(params, "lm_head")
    assert set(ref.flat(ref.initial_weights(cfg, SEED, "cpu"))) == {
        n for n, _ in params.named_parameters()}
    # the full configuration: attention at layers 7 and 21, Δ at rank 160
    full = model_config(json.loads(
        (ROOT / "portbench" / "configs" / "jamba2-3b.json").read_text()))
    assert [l for l in range(full.n_layers)
            if jamba.is_attn_layer(full, l)] == [7, 21]
    assert (full.ssm.dt_rank, full.n_heads, full.n_kv_heads) == (160, 20, 1)
    assert tuple(ssm.init_ssm_params(0, mc, torch.float32, device="cpu")
                 .state_dict()) == ssm.PUBLISHED_KEYS


def test_default_config_keeps_the_rank_one_mixer():
    cfg = reduced(get_config("jamba-v0.1-52b"))
    assert ssm.dt_rank(cfg.ssm) == 0 and jamba._rope(cfg, 5) == 5
    assert type(cfg) is ModelConfig and not cfg.tie_embeddings
    p = ssm.init_ssm_params(0, cfg, torch.float32, device="cpu")
    assert tuple(p.state_dict()) == ssm.KEYS
    assert hasattr(jamba.init_params(cfg, 0, device="cpu"), "lm_head")
    # a JambaConfig at its defaults is that config, field for field
    same = jamba.JambaConfig(**dataclasses.asdict(cfg) | {
        "moe": cfg.moe, "ssm": ssm.MambaConfig(**dataclasses.asdict(cfg.ssm))})
    assert same.param_count() == cfg.param_count()
    torch.testing.assert_close(
        jamba.init_params(same, 3, device="cpu").state_dict(),
        jamba.init_params(cfg, 3, device="cpu").state_dict(), rtol=0, atol=0)
    published = ssm.init_ssm_params(0, model_config(tiny()), torch.float32,
                                    device="cpu").state_dict()
    with pytest.raises(ValueError, match="dt_proj"):
        ssm.Mamba({k: v for k, v in published.items() if k != "dt_proj"})


@pytest.mark.parametrize("norm", ["dt_norm", "b_norm", "c_norm"])
def test_published_mixer_norms_its_projection(norm):
    """With ``dt_rank`` > 0 each of Δ, B and C passes through its RMS norm:
    scaling that slice of ``x_proj`` leaves the block's output as it was,
    and scaling the norm's weight does not."""
    mc = model_config(tiny())
    r, n = mc.ssm.dt_rank, mc.ssm.d_state
    cols = {"dt_norm": slice(0, r), "b_norm": slice(r, r + n),
            "c_norm": slice(r + n, r + 2 * n)}[norm]
    p = ssm.init_ssm_params(5, mc, torch.float32, device="cpu").state_dict()
    x = torch.randn(2, 16, mc.d_model,
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want, _, _ = ssm.mamba_block(mc, x, p)
        scaled = dict(p, x_proj=p["x_proj"].clone())
        scaled["x_proj"][:, cols] *= 4.0
        got, _, _ = ssm.mamba_block(mc, x, scaled)
        moved, _, _ = ssm.mamba_block(mc, x, dict(p, **{norm: p[norm] * 2}))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert not torch.allclose(moved, want, rtol=1e-2, atol=1e-4)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_equal_the_reference(monkeypatch, remat):
    monkeypatch.setattr(ref, "CHUNK", 16)
    monkeypatch.setattr(ref, "Q_BLOCK", 16)
    cfg = tiny(remat=remat)
    mc = model_config(cfg)
    params = jamba.build(mc, ref.initial_weights(cfg, SEED, "cpu"))
    params.requires_grad_(True)
    tokens, targets = _tokens(cfg)
    loss = jamba.loss_fn(mc, params, tokens, targets, seq_chunk=16)
    named = dict(params.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))

    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in ref.flat(ref.initial_weights(cfg, SEED,
                                                       "cpu")).items()}
    want = sum(ref.row_loss(leaves, cfg, tokens[i:i + 1], targets[i:i + 1],
                            seq_chunk=16) for i in range(B)) / B
    want_grads = torch.autograd.grad(want, [leaves[n] for n in named])
    assert abs(float(loss.detach()) - float(want.detach())) <= 1e-6 * abs(
        float(want.detach()))
    for name, g, w in zip(named, grads, want_grads, strict=True):
        gap = float((g - w).norm() / w.norm().clamp_min(1e-30))
        assert gap <= 1e-5, (name, gap)


def _pad(cache, length):
    """The prefill's KV caches grown to ``length`` slots, as the engine
    pads them before decoding."""
    def grow(x):
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, length - x.shape[1]))

    cache.kv = [None if kv is None else
                KVCache(k=grow(kv.k), v=grow(kv.v), length=kv.length)
                for kv in cache.kv]
    return cache


def test_prefill_then_decode_equal_the_full_forward():
    mc = model_config(tiny())
    params = jamba.build(mc, ref.initial_weights(tiny(), SEED, "cpu"))
    tokens, _ = _tokens(tiny())
    p0 = T - 3
    with torch.no_grad():
        full, _ = jamba.forward(mc, params, tokens)
        want = jamba.logits_fn(mc, params, full)
        logits, cache = jamba.prefill(mc, params, tokens[:, :p0])
        torch.testing.assert_close(logits, want[:, p0 - 1:p0], atol=1e-5,
                                   rtol=1e-5)
        cache = _pad(cache, T)
        zeroed = dataclasses.replace(
            cache, ssm=[None if s is None else torch.zeros_like(s)
                        for s in cache.ssm])
        for pos in range(p0, T):
            logits, cache = jamba.decode_step(mc, params, cache,
                                              tokens[:, pos:pos + 1], pos)
            torch.testing.assert_close(logits, want[:, pos:pos + 1],
                                       atol=1e-5, rtol=1e-5)
        bad, _ = jamba.decode_step(mc, params, zeroed,
                                   tokens[:, p0:p0 + 1], p0)
        assert not torch.allclose(bad, want[:, p0:p0 + 1], atol=1e-3)
