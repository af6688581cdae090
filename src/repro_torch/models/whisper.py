"""Whisper-small encoder–decoder backbone — arXiv:2212.04356.

Port of ``repro/models/whisper.py``.  The audio frontend (two 1-D convs
with stride-2 downsampling over log-mel frames) is a STUB, as in the
reference: callers supply frame embeddings [B, T_frames, D].  Encoder =
bidirectional self-attn; decoder = causal self-attn + cross-attn to the
encoder output.  LayerNorm (with bias) as in the paper; sinusoidal
positions on the encoder, learned positions on the decoder.  The MLP's
gelu is the tanh approximation, as ``jax.nn.gelu`` computes it by default
(``torch``'s default is the erf form).

The weights are a :class:`Whisper`
:class:`~repro_torch.models.transformer.Tree` named as in the JAX tree
(``p["norm1"]["scale"]``).  Every prefill attention runs the flash kernel
on the card (encoder self-attention, decoder self-attention and
cross-attention: 3 launches a layer pair); decode attends over the
self-KV cache in plain torch, written in place, and cross-attends with
``attention_direct``, as the reference does.  The family has no paged
decode path and serves through ``Engine._generate_legacy``.
:func:`loss_fn` trains every attention on the flash kernel and its
backward (encoder non-causal, decoder causal, cross-attention with the
frames' length as S), each block rematerialized under ``cfg.remat``.

Mixed dtypes follow JAX's promotion: every product runs in the promoted
type of its operands (:func:`_mm`), so bf16 weights on fp32 frames encode
in fp32, and the decoder's cross-attention takes fp32 keys and values
against bf16 queries (``layers.attention_chunked`` and ``_attend`` give
the reference's result dtypes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from ..mpc.errors import ShapeContractError
from ..mpc.field import generator
from .config import ModelConfig
from .layers import (
    KVCache,
    attention_chunked,
    attention_direct,
    decode_attention,
    remat,
)
from .transformer import Tree, chunked_xent

MAX_DEC_POS = 1 << 16


class Whisper(Tree):
    """The whole model's weights: ``embed [Vp, D]`` (also the tied head),
    ``dec_pos [MAX_DEC_POS, D]``, ``enc_layers``, ``dec_layers``,
    ``enc_norm`` and ``dec_norm``."""


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in fp32, back in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale.float()
            + bias.float()).to(x.dtype)


def sinusoids(length: int, d: int, *, device=None) -> torch.Tensor:
    """``[length, d]`` fp32 encoder positions: sin then cos of ``pos ·
    10000^(-i / (half - 1))``.  Computed in float64 and rounded once, so
    each value is the fp32 nearest the exact one."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float64, device=device)
                      / (half - 1))
    ang = torch.arange(length, dtype=torch.float64, device=device)[:, None] \
        * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()


# ------------------------------------------------------------------- init --
def init_params(cfg: ModelConfig, key, *, device) -> Whisper:
    """Random weights as the JAX ``init_params`` draws them (normal, scaled
    by ``fan_in ** -0.5``; norms at scale 1, bias 0), from ``key`` (an int
    seed or a ``torch.Generator``) on ``device``.  Torch and JAX draw
    different numbers; tests carry JAX's weights across with
    :func:`~repro_torch.models.convert.params_from_numpy`."""
    dev = torch.device(device)
    g = generator(key, dev)
    dt = _dtype(cfg)
    d, hd, h = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads
    n_enc = cfg.n_enc_layers or cfg.n_layers

    def mk(shape, scale_dim=d):
        x = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
        return (x * scale_dim ** -0.5).to(dt)

    def norm():
        return {"scale": torch.ones(d, dtype=dt, device=dev),
                "bias": torch.zeros(d, dtype=dt, device=dev)}

    def attn(prefix=""):
        return {f"{prefix}w_q": mk((d, h * hd)), f"{prefix}w_k": mk((d, h * hd)),
                f"{prefix}w_v": mk((d, h * hd)),
                f"{prefix}w_o": mk((h * hd, d), h * hd)}

    def mlp():
        return {"w1": mk((d, cfg.d_ff)), "w2": mk((cfg.d_ff, d), cfg.d_ff)}

    enc = [{"norm1": norm(), "norm2": norm(), **attn(), **mlp()}
           for _ in range(n_enc)]
    dec = [{"norm1": norm(), "norm2": norm(), "norm3": norm(), **attn(),
            **attn("x_"), **mlp()} for _ in range(cfg.n_layers)]
    return Whisper({"embed": mk((cfg.padded_vocab(), d)),
                    "dec_pos": mk((MAX_DEC_POS, d)),
                    "enc_layers": enc, "dec_layers": dec,
                    "enc_norm": norm(), "dec_norm": norm()})


# ------------------------------------------------------------- components --
def _ln(x: torch.Tensor, norm, eps: float) -> torch.Tensor:
    return layer_norm(x, norm["scale"], norm["bias"], eps)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted type of the two, as JAX's ``x @ w``
    computes it (torch's ``@`` refuses operands of two dtypes)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _heads(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], x.shape[1], cfg.n_heads,
                     cfg.resolved_head_dim)


def _mha(cfg: ModelConfig, x: torch.Tensor, p, kv: Optional[torch.Tensor] = None,
         *, causal: bool, prefix: str = "", direct: bool = False):
    """Multi-head attention of x over ``kv`` (x itself when None): the
    flash kernel, or ``attention_direct`` when ``direct`` (decode
    cross-attention)."""
    b, t, _ = x.shape
    src = x if kv is None else kv
    q = _heads(cfg, _mm(x, p[f"{prefix}w_q"]))
    k = _heads(cfg, _mm(src, p[f"{prefix}w_k"]))
    v = _heads(cfg, _mm(src, p[f"{prefix}w_v"]))
    if direct:
        out = attention_direct(q, k, v, causal=causal)
    else:
        out = attention_chunked(q, k, v, causal=causal)
    return _mm(out.reshape(b, t, -1), p[f"{prefix}w_o"])


def _mlp(x: torch.Tensor, p) -> torch.Tensor:
    return _mm(F.gelu(_mm(x, p["w1"]), approximate="tanh"), p["w2"])


def encode(cfg: ModelConfig, params: Whisper, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames: [B, T_frames, D] (frontend stub output) -> [B, T, D]."""
    x = frames + sinusoids(frames.shape[1], cfg.d_model,
                           device=frames.device).to(frames.dtype)
    eps = cfg.norm_eps

    def block(x, p):
        x = x + _mha(cfg, _ln(x, p["norm1"], eps), p, causal=False)
        return x + _mlp(_ln(x, p["norm2"], eps), p)

    for p in params.enc_layers:
        x = remat(block, x, p) if cfg.remat else block(x, p)
    return _ln(x, params.enc_norm, eps)


def _dec_embed(cfg: ModelConfig, params: Whisper, tokens: torch.Tensor):
    return params.embed[tokens] + params.dec_pos[:tokens.shape[1]][None].to(
        _dtype(cfg))


def decode_train(cfg: ModelConfig, params: Whisper, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    eps = cfg.norm_eps

    def block(x, p):
        x = x + _mha(cfg, _ln(x, p["norm1"], eps), p, causal=True)
        x = x + _mha(cfg, _ln(x, p["norm2"], eps), p, kv=enc_out, causal=False,
                     prefix="x_")
        return x + _mlp(_ln(x, p["norm3"], eps), p)

    x = _dec_embed(cfg, params, tokens)
    for p in params.dec_layers:
        x = remat(block, x, p) if cfg.remat else block(x, p)
    return _ln(x, params.dec_norm, eps)


def forward(cfg: ModelConfig, params: Whisper, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None):
    """embeds = encoder frames (stub).  Returns (hidden, aux 0)."""
    if embeds is None:
        raise ShapeContractError("whisper needs frame embeddings")
    enc = encode(cfg, params, embeds)
    hid = decode_train(cfg, params, tokens, enc)
    return hid, torch.zeros((), dtype=torch.float32, device=hid.device)


def logits_fn(cfg: ModelConfig, params: Whisper,
              hidden: torch.Tensor) -> torch.Tensor:
    out = hidden @ params.embed.T.to(hidden.dtype)  # tied head
    vp = out.shape[-1]
    if vp != cfg.vocab:  # mask padded vocab ids
        pad = torch.arange(vp, device=out.device) >= cfg.vocab
        out = out.masked_fill(pad, -1e30)
    return out


def loss_fn(cfg: ModelConfig, params: Whisper, tokens, targets, *,
            seq_chunk: int = 512, embeds=None) -> torch.Tensor:
    """Next-token cross entropy of the decoder, sequence-chunked softmax;
    ``embeds`` are the encoder frames (the frontend stub's output)."""
    hidden, _ = forward(cfg, params, tokens, embeds=embeds)
    return chunked_xent(cfg, params, hidden, targets, seq_chunk, logits_fn)


@dataclasses.dataclass
class WhisperCache:
    self_kv: List[KVCache]   # per decoder layer
    enc_out: torch.Tensor    # [B, S_enc, D]
    length: int


def prefill(cfg: ModelConfig, params: Whisper, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None):
    """Serving prefill: encode audio frames, run the decoder prompt, return
    last logits + (decoder self-KV, encoder output) cache."""
    if embeds is None:
        raise ShapeContractError("whisper prefill needs frame embeddings")
    eps = cfg.norm_eps
    enc = encode(cfg, params, embeds)
    b, t = tokens.shape
    x = _dec_embed(cfg, params, tokens)
    self_kv = []
    for p in params.dec_layers:
        h = _ln(x, p["norm1"], eps)
        q, k, v = (_heads(cfg, _mm(h, p[name])) for name in ("w_q", "w_k", "w_v"))
        attn = attention_chunked(q, k, v, causal=True)
        x = x + _mm(attn.reshape(b, t, -1), p["w_o"])
        x = x + _mha(cfg, _ln(x, p["norm2"], eps), p, kv=enc, causal=False,
                     prefix="x_")
        x = x + _mlp(_ln(x, p["norm3"], eps), p)
        self_kv.append(KVCache(k=k, v=v, length=t))
    x = _ln(x, params.dec_norm, eps)
    logits = logits_fn(cfg, params, x[:, -1:])
    return logits, WhisperCache(self_kv=self_kv, enc_out=enc, length=t)


# ----------------------------------------------------------------- decode --
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               enc_out: Optional[torch.Tensor] = None, *,
               device) -> WhisperCache:
    """Zero self-KV of ``max_len`` slots a decoder layer on ``device``;
    ``enc_out`` defaults to zeros ``[batch, max_len, D]``, as the
    reference's does."""
    dt = _dtype(cfg)
    if enc_out is None:
        enc_out = torch.zeros((batch, max_len, cfg.d_model), dtype=dt,
                              device=device)
    shape = (batch, max_len, cfg.n_heads, cfg.resolved_head_dim)
    return WhisperCache(
        self_kv=[KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                         v=torch.zeros(shape, dtype=dt, device=device),
                         length=0)
                 for _ in range(cfg.n_layers)],
        enc_out=enc_out, length=0)


def decode_step(cfg: ModelConfig, params: Whisper, cache: WhisperCache,
                token: torch.Tensor, pos: int):
    """One decode step.  token: [B, 1] int; pos: int (the self-KV slot to
    write, and the decoder position).  The self-KV is written in place.

    Returns (logits [B, 1, Vp], cache)."""
    eps = cfg.norm_eps
    x = params.embed[token] + params.dec_pos[pos][None, None].to(_dtype(cfg))
    new_kv = []
    for p, lc in zip(params.dec_layers, cache.self_kv, strict=True):
        h = _ln(x, p["norm1"], eps)
        q, k_new, v_new = (_heads(cfg, _mm(h, p[name]))
                           for name in ("w_q", "w_k", "w_v"))
        attn, nlc = decode_attention(q, lc, k_new, v_new, pos=pos)
        x = x + _mm(attn.reshape(x.shape[0], 1, -1), p["w_o"])
        new_kv.append(nlc)
        x = x + _mha(cfg, _ln(x, p["norm2"], eps), p, kv=cache.enc_out,
                     causal=False, prefix="x_", direct=True)
        x = x + _mlp(_ln(x, p["norm3"], eps), p)
    x = _ln(x, params.dec_norm, eps)
    return logits_fn(cfg, params, x), WhisperCache(
        self_kv=new_kv, enc_out=cache.enc_out, length=cache.length + 1)
