"""Decoder-only LM: the dense GQA, MoE and VLM-backbone families.

Port of ``repro/models/transformer.py``; the functions keep the JAX names
and signatures so each has an obvious counterpart.  Weights are
:class:`Transformer` modules holding one :class:`Layer` per block (a
:class:`MoELayer` for a config with ``moe``; JAX stacks them ``[L, ...]``
for ``lax.scan``, the port loops over layers).  Prefill attention runs the
flash kernel on the card
(:func:`~repro_torch.models.layers.attention_chunked`); decode attends over
a contiguous or paged KV cache in plain torch, written in place.  A MoE
block's FFN is :func:`~repro_torch.models.moe.moe_ffn` in every path.

Weights are frozen parameters (``requires_grad=False``) as serving builds
them; ``model.requires_grad_(True)`` makes them trainable, as
``train.step.init_train_state`` and ``convert.params_from_numpy(...,
trainable=True)`` do.  :func:`loss_fn` is the reference's: next-token
cross entropy over sequence chunks whose logits are recomputed in the
backward pass (``jax.checkpoint`` → :func:`~repro_torch.models.layers.remat`),
plus ``0.01 * aux`` of the MoE; ``cfg.remat`` rematerializes each layer
(blocks of ``cfg.remat_block`` layers, with the layers inside them
rematerialized again, when that is above 1).  The same chunked loss
serves the other families (:func:`chunked_xent`).
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
from torch import nn

from .. import spans
from ..mpc.field import generator
from .config import ModelConfig
from .layers import (
    KVCache,
    PagedKVCache,
    attention_chunked,
    decode_attention,
    gqa_project,
    paged_decode_attention,
    remat,
    rms_norm,
    swiglu,
)
from .moe import init_moe_params, moe_ffn

ATTN_KEYS = ("attn_norm", "w_q", "w_k", "w_v", "w_o", "ffn_norm")
LAYER_KEYS = ATTN_KEYS + ("w1", "w3", "w2")
MOE_LAYER_KEYS = ATTN_KEYS + ("router", "moe_w1", "moe_w3", "moe_w2")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Layer(nn.Module):
    """One block's weights, named as in the JAX ``params["layers"]`` tree;
    ``layer["w_q"]`` reads like the JAX dict.  ``KEYS`` names them (a
    family with other blocks subclasses this with its own)."""

    KEYS = LAYER_KEYS

    def __init__(self, weights: Mapping[str, torch.Tensor]):
        super().__init__()
        for name in self.KEYS:
            self.register_parameter(name, _frozen(weights[name]))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


class MoELayer(Layer):
    """A MoE block: the attention weights and the router and expert
    weights ``router [D, E]``, ``moe_w1``/``moe_w3 [E, D, F]``, ``moe_w2
    [E, F, D]``."""

    KEYS = MOE_LAYER_KEYS


class Tree(nn.Module):
    """Weights from a nested tree named as in a JAX ``init_params`` tree:
    a tensor becomes a frozen parameter, a mapping a child ``Tree`` and a
    list of mappings an ``nn.ModuleList`` of them, so ``p["w_q"]``,
    ``p["norm1"]["scale"]`` and ``p["layers"][3]`` read like the JAX
    dicts.  For the families whose layers are not all alike (hybrid,
    encdec)."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(name, _frozen(value))
            elif isinstance(value, Mapping):
                self.add_module(name, Tree(value))
            else:
                self.add_module(name, nn.ModuleList(Tree(v) for v in value))

    def __getitem__(self, name: str):
        return getattr(self, name)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def layer_class(cfg: ModelConfig) -> type:
    return MoELayer if cfg.moe is not None else Layer


class Transformer(nn.Module):
    """The whole model's weights: ``embed [Vp, D]``, ``layers``,
    ``final_norm [D]`` and, when the embeddings are not tied,
    ``lm_head [D, Vp]``."""

    def __init__(self, embed: torch.Tensor, layers, final_norm: torch.Tensor,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = _frozen(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = _frozen(final_norm)
        self.lm_head = None if lm_head is None else _frozen(lm_head)

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ------------------------------------------------------------------- init --
def init_params(cfg: ModelConfig, key, *, device) -> Transformer:
    """Random weights as the JAX ``init_params`` draws them (normal, scaled
    by ``fan_in ** -0.5``; norms at 1), from ``key`` (an int seed or a
    ``torch.Generator``) on ``device``.  Torch and JAX draw different
    numbers; tests carry JAX's weights across with
    :func:`~repro_torch.models.convert.params_from_numpy`."""
    dev = torch.device(device)
    g = generator(key, dev)
    dt = _dtype(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim

    def mk(shape, scale_dim=d):
        x = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
        return (x * scale_dim ** -0.5).to(dt)

    def ones(n):
        return torch.ones(n, dtype=dt, device=dev)

    def block():
        w = {"attn_norm": ones(d),
             "w_q": mk((d, cfg.n_heads * hd)),
             "w_k": mk((d, cfg.n_kv_heads * hd)),
             "w_v": mk((d, cfg.n_kv_heads * hd)),
             "w_o": mk((cfg.n_heads * hd, d), cfg.n_heads * hd),
             "ffn_norm": ones(d)}
        if cfg.moe is not None:
            w.update(init_moe_params(g, d, cfg.moe, dt, device=dev))
            return MoELayer(w)
        w.update({"w1": mk((d, cfg.d_ff)), "w3": mk((d, cfg.d_ff)),
                  "w2": mk((cfg.d_ff, d), cfg.d_ff)})
        return Layer(w)

    layers = [block() for _ in range(cfg.n_layers)]
    embed = mk((cfg.padded_vocab(), d))
    lm_head = None if cfg.tie_embeddings else mk((d, cfg.padded_vocab()))
    return Transformer(embed, layers, ones(d), lm_head)


# ---------------------------------------------------------------- forward --
def _ffn(cfg: ModelConfig, h, p: Layer):
    """The block's FFN and its aux loss (0 for the dense FFN)."""
    if cfg.moe is not None:
        return moe_ffn(h, p, cfg.moe)
    return swiglu(h, p["w1"], p["w3"], p["w2"]), 0.0


def _layer(cfg: ModelConfig, x, p: Layer, positions, collect_kv: bool = False):
    """One transformer block (train/prefill path); returns ``(x, aux, kv)``."""
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = gqa_project(h, p, cfg, positions=positions)
    attn = attention_chunked(q, k, v, causal=True)
    b, t, _, _ = attn.shape
    x = x + attn.reshape(b, t, -1) @ p["w_o"]
    h = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    ffn, aux = _ffn(cfg, h, p)
    return x + ffn, aux, ((k, v) if collect_kv else None)


def _embed(params: Transformer, tokens, embeds):
    x = params.embed[tokens]                          # [B, T_text, D]
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)[None].expand(b, t)
    return x, positions


@spans.spanned("model.layers")
def run_layers(cfg: ModelConfig, body, x, layers):
    """``x, aux = body(x, aux, layer)`` over ``layers``, under ``cfg.remat``
    as the reference's scan: each layer rematerialized and, with
    ``remat_block`` k > 1, each block of k layers rematerialized as a whole
    too (the last ``L mod k`` layers on their own).  ``aux`` starts at a
    0-d fp32 zero."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not cfg.remat:
        for lp in layers:
            x, aux = body(x, aux, lp)
        return x, aux

    def step(x, aux, lp):
        return remat(body, x, aux, lp)

    k = cfg.remat_block
    l1 = (len(layers) // k) * k if k > 1 else 0
    for b0 in range(0, l1, k):
        def block(x, aux, b0=b0):
            for lp in layers[b0:b0 + k]:
                x, aux = step(x, aux, lp)
            return x, aux
        x, aux = remat(block, x, aux)
    for lp in layers[l1:]:
        x, aux = step(x, aux, lp)
    return x, aux


def forward(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: [B, T_text] int; embeds: [B, T_front, D] (vlm stub).

    Returns (hidden [B, T, D], aux loss scalar: the MoE load-balance loss
    averaged over the layers, 0 for the dense FFN)."""
    x, positions = _embed(params, tokens, embeds)

    def body(x, aux, lp):
        x, a, _ = _layer(cfg, x, lp, positions)
        return x, aux + a

    x, aux = run_layers(cfg, body, x, list(params.layers))
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, aux / cfg.n_layers


def prefill(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None):
    """Serving prefill: last-position logits + a filled KV cache
    ``[L, B, T, Hkv, D]``."""
    x, positions = _embed(params, tokens, embeds)
    ks, vs = [], []
    for lp in params.layers:
        x, _, (k, v) = _layer(cfg, x, lp, positions, collect_kv=True)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = logits_fn(cfg, params, x[:, -1:])
    cache = KVCache(k=torch.stack(ks), v=torch.stack(vs), length=x.shape[1])
    return logits, cache


def logits_fn(cfg: ModelConfig, params: Transformer,
              hidden: torch.Tensor) -> torch.Tensor:
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    out = hidden @ head.to(hidden.dtype)
    vp = out.shape[-1]
    if vp != cfg.vocab:  # mask padded vocab ids
        pad = torch.arange(vp, device=out.device) >= cfg.vocab
        out = out.masked_fill(pad, -1e30)
    return out


@spans.spanned("model.loss")
def chunked_xent(cfg: ModelConfig, params, hidden: torch.Tensor,
                 targets: torch.Tensor, seq_chunk: int, logits) -> torch.Tensor:
    """Mean next-token cross entropy of ``hidden [B, T, D]`` against
    ``targets [B, T']``, the reference's chunked form: positions a
    frontend prepended (``T > T'``) have no label and are cut, the
    sequence is cut into ``min(seq_chunk, T')`` chunks (a ragged tail is
    dropped, as there), and each chunk's fp32 logits
    (``logits(cfg, params, h)``) are rematerialized, so the backward pass
    holds one chunk's ``[B, chunk, Vp]`` at a time.  Returns the mean of
    the chunks' means."""
    t = hidden.shape[1]
    if targets.shape[1] != t:
        hidden = hidden[:, t - targets.shape[1]:]
        t = targets.shape[1]
    chunk = min(seq_chunk, t)

    def one(hx, tx):
        lg = logits(cfg, params, hx).float()
        lse = torch.logsumexp(lg, dim=-1)
        picked = lg.gather(-1, tx[..., None].long())[..., 0]
        return (lse - picked).mean()

    losses = [remat(one, hidden[:, c0:c0 + chunk], targets[:, c0:c0 + chunk])
              for c0 in range(0, (t // chunk) * chunk, chunk)]
    return torch.stack(losses).mean()


def loss_fn(cfg: ModelConfig, params: Transformer, tokens, targets, *,
            seq_chunk: int = 512, embeds=None) -> torch.Tensor:
    """Next-token cross entropy, sequence-chunked softmax, plus ``0.01 *
    aux`` (the MoE's load-balance loss; 0 for the dense FFN)."""
    hidden, aux = forward(cfg, params, tokens, embeds=embeds)
    return chunked_xent(cfg, params, hidden, targets, seq_chunk,
                        logits_fn) + 0.01 * aux


# ----------------------------------------------------------------- decode --
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device) -> KVCache:
    """Stacked ``[L, B, S, Hkv, hd]`` cache on ``device``."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=_dtype(cfg), device=device),
                   v=torch.zeros(shape, dtype=_dtype(cfg), device=device),
                   length=0)


def _decode_layers(cfg: ModelConfig, params: Transformer, token, positions,
                   attend):
    """The decode step's body over every layer; ``attend(l, q, k_new,
    v_new)`` writes layer ``l``'s cache and returns its attention."""
    x = params.embed[token]                           # [B, 1, D]
    b = x.shape[0]
    for li, lp in enumerate(params.layers):
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k_new, v_new = gqa_project(h, lp, cfg, positions=positions)
        x = x + attend(li, q, k_new, v_new).reshape(b, 1, -1) @ lp["w_o"]
        h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
        x = x + _ffn(cfg, h, lp)[0]
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_fn(cfg, params, x)


def decode_step(cfg: ModelConfig, params: Transformer, cache: KVCache,
                token: torch.Tensor, pos: int):
    """One decode step.  token: [B, 1] int; pos: int (slot to write).

    Returns (logits [B, 1, Vp], cache); the cache is updated in place."""
    b = token.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=token.device)

    def attend(li, q, k_new, v_new):
        layer = KVCache(k=cache.k[li], v=cache.v[li], length=cache.length)
        out, _ = decode_attention(q, layer, k_new, v_new, pos=pos)
        return out

    logits = _decode_layers(cfg, params, token, positions, attend)
    return logits, KVCache(k=cache.k, v=cache.v, length=cache.length + 1)


def init_paged_cache(cfg: ModelConfig, n_blocks: int, block_size: int, *,
                     device) -> PagedKVCache:
    """Stacked ``[L, NB, BS, Hkv, hd]`` block pool on ``device``."""
    return PagedKVCache.init(n_blocks, block_size, cfg.n_kv_heads,
                             cfg.resolved_head_dim, _dtype(cfg),
                             leading=(cfg.n_layers,), device=device)


def decode_step_paged(cfg: ModelConfig, params: Transformer,
                      pool: PagedKVCache, tables: torch.Tensor,
                      token: torch.Tensor, pos: torch.Tensor):
    """One decode step over the paged pool, the continuous-batching twin of
    :func:`decode_step`.  token: [B, 1] int; tables: [B, MB] int; pos: [B]
    int per-lane positions.

    Returns (logits [B, 1, Vp], pool); the pool is updated in place."""

    def attend(li, q, k_new, v_new):
        out, _, _ = paged_decode_attention(q, pool.k[li], pool.v[li], tables,
                                           k_new, v_new, pos=pos)
        return out

    logits = _decode_layers(cfg, params, token, pos[:, None], attend)
    return logits, pool
