"""Jamba hybrid (Mamba + attention 1:7 interleave, MoE every other layer) —
arXiv:2403.19887.

Port of ``repro/models/jamba.py``.  Layer ``l`` uses attention iff
``l % attn_every == attn_offset`` (default 1-in-8, middle of the block),
Mamba otherwise; the FFN is MoE (16e top-2) on odd layers, dense SwiGLU on
even.  Layers are heterogeneous, so the weights are a :class:`Jamba`
:class:`~repro_torch.models.transformer.Tree` of per-layer trees named as
in the JAX ``init_params`` tree (a mamba layer's block under ``"mamba"``,
a :class:`~repro_torch.models.ssm.Mamba`).

Prefill attention runs the flash kernel on the card and the Mamba layers
the selective-scan kernel.  Decode attends over a windowed KV cache in
plain torch, written in place, and steps the Mamba states in plain torch,
as the JAX package computes both in XLA.  The family has no paged decode
path and serves through ``Engine._generate_legacy``.

:func:`loss_fn` (cross entropy plus ``0.01 * aux`` of the MoE) trains on
either device: under autograd the scan runs through
:class:`~repro_torch.kernels.selective_scan.SelectiveScan`, whose backward
is the hand-written ``selective_scan_bwd`` kernel on the card (from the
forward launch's checkpoints) and its plain version on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..mpc.field import generator
from .config import ModelConfig
from .layers import (
    KVCache,
    attention_chunked,
    decode_attention,
    gqa_project,
    remat,
    rms_norm,
    swiglu,
)
from .moe import init_moe_params, moe_ffn
from .ssm import Mamba, init_ssm_params, init_states, mamba_block
from .transformer import Tree, chunked_xent
from .transformer import logits_fn as logits_fn

# attention layers cap their KV window at long context (128k) — the hybrid's
# long-range memory lives in the Mamba states.
ATTN_WINDOW = 131072


class Jamba(Tree):
    """The whole model's weights: ``embed [Vp, D]``, ``layers`` (one tree a
    layer), ``final_norm [D]`` and ``lm_head [D, Vp]`` (never tied)."""


def is_attn_layer(cfg: ModelConfig, l: int) -> bool:
    return cfg.attn_every > 0 and l % cfg.attn_every == cfg.attn_offset


def is_moe_layer(cfg: ModelConfig, l: int) -> bool:
    return cfg.moe is not None and l % 2 == 1


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ------------------------------------------------------------------- init --
def init_params(cfg: ModelConfig, key, *, device) -> Jamba:
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

    def ones():
        return torch.ones(d, dtype=dt, device=dev)

    layers = []
    for l in range(cfg.n_layers):
        p = {"pre_norm": ones(), "ffn_norm": ones()}
        if is_attn_layer(cfg, l):
            p.update({
                "w_q": mk((d, cfg.n_heads * hd)),
                "w_k": mk((d, cfg.n_kv_heads * hd)),
                "w_v": mk((d, cfg.n_kv_heads * hd)),
                "w_o": mk((cfg.n_heads * hd, d), cfg.n_heads * hd),
            })
        else:
            p["mamba"] = init_ssm_params(g, cfg, dt, device=dev)
        if is_moe_layer(cfg, l):
            p.update(init_moe_params(g, d, cfg.moe, dt, device=dev))
        else:
            p.update({"w1": mk((d, cfg.d_ff)), "w3": mk((d, cfg.d_ff)),
                      "w2": mk((cfg.d_ff, d), cfg.d_ff)})
        layers.append(p)
    vp = cfg.padded_vocab()
    return build(cfg, {"embed": mk((vp, d)), "layers": layers,
                       "final_norm": ones(), "lm_head": mk((d, vp))})


def build(cfg: ModelConfig, tree) -> Jamba:
    """The :class:`Jamba` module of a tree of tensors shaped as the JAX
    ``init_params`` tree; each mamba layer's block (a mapping or already a
    :class:`~repro_torch.models.ssm.Mamba`) becomes a ``Mamba``."""
    model = Jamba({k: v for k, v in tree.items() if k != "layers"})
    layers = []
    for l, p in enumerate(tree["layers"]):
        layer = Tree({k: v for k, v in p.items() if k != "mamba"})
        if not is_attn_layer(cfg, l):
            m = p["mamba"]
            layer.mamba = m if isinstance(m, Mamba) else Mamba(m)
        layers.append(layer)
    model.layers = torch.nn.ModuleList(layers)
    return model


# ---------------------------------------------------------------- forward --
def _mix(cfg: ModelConfig, l: int, x, p, positions):
    """One layer's token mixer on the prefill path: ``(mix, (k, v, conv,
    ssm))``, the state its cache keeps."""
    b, t, _ = x.shape
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    if is_attn_layer(cfg, l):
        q, k, v = gqa_project(h, p, cfg, positions=positions)
        attn = attention_chunked(q, k, v, causal=True)
        return attn.reshape(b, t, -1) @ p["w_o"], (k, v, None, None)
    mix, nc, ns = mamba_block(cfg, h, p["mamba"])
    return mix, (None, None, nc, ns)


def _ffn(cfg: ModelConfig, l: int, x, p):
    """The layer's FFN and its aux loss (0 on the dense layers)."""
    h = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if is_moe_layer(cfg, l):
        return moe_ffn(h, p, cfg.moe)
    return swiglu(h, p["w1"], p["w3"], p["w2"]), 0.0


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, t, _ = x.shape
    return torch.arange(t, device=x.device)[None].expand(b, t)


def forward(cfg: ModelConfig, params: Jamba, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None):
    """tokens: [B, T] int -> (hidden [B, T, D], aux: the MoE load-balance
    loss summed over the layers and divided by ``n_layers``)."""
    x = params.embed[tokens]
    positions = _positions(x)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(x, l, p):
        x = x + _mix(cfg, l, x, p, positions)[0]
        ffn, aux = _ffn(cfg, l, x, p)
        return x + ffn, aux

    for l, p in enumerate(params.layers):
        x, aux = remat(block, x, l, p) if cfg.remat else block(x, l, p)
        aux_total = aux_total + aux
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, aux_total / cfg.n_layers


def loss_fn(cfg: ModelConfig, params: Jamba, tokens, targets, *,
            seq_chunk: int = 512, embeds=None) -> torch.Tensor:
    """Next-token cross entropy, sequence-chunked softmax, plus ``0.01 *
    aux`` (the MoE layers' load-balance loss)."""
    hidden, aux = forward(cfg, params, tokens)
    return chunked_xent(cfg, params, hidden, targets, seq_chunk,
                        logits_fn) + 0.01 * aux


@dataclasses.dataclass
class JambaCache:
    """Per-layer decode state: KV for the attention layers, conv/ssm states
    for the Mamba layers, ``None`` where a layer has none."""
    kv: List[Optional[KVCache]]          # per attn layer
    conv: List[Optional[torch.Tensor]]   # per mamba layer
    ssm: List[Optional[torch.Tensor]]
    length: int


def prefill(cfg: ModelConfig, params: Jamba, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None):
    """Serving prefill: last logits + hybrid cache (KV for attn layers,
    conv/ssm states for Mamba layers)."""
    x = params.embed[tokens]
    t = x.shape[1]
    positions = _positions(x)
    kv, conv, ssm = [], [], []
    for l, p in enumerate(params.layers):
        mix, (k, v, nc, ns) = _mix(cfg, l, x, p, positions)
        x = x + mix
        x = x + _ffn(cfg, l, x, p)[0]
        kv.append(None if k is None else KVCache(k=k, v=v, length=t))
        conv.append(nc)
        ssm.append(ns)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = logits_fn(cfg, params, x[:, -1:])
    return logits, JambaCache(kv=kv, conv=conv, ssm=ssm, length=t)


# ----------------------------------------------------------------- decode --
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device) -> JambaCache:
    """Zero states on ``device``; the attention layers' KV holds
    ``min(max_len, ATTN_WINDOW)`` slots."""
    window = min(max_len, ATTN_WINDOW)
    shape = (batch, window, cfg.n_kv_heads, cfg.resolved_head_dim)
    kv, conv, ssm = [], [], []
    for l in range(cfg.n_layers):
        if is_attn_layer(cfg, l):
            kv.append(KVCache(
                k=torch.zeros(shape, dtype=_dtype(cfg), device=device),
                v=torch.zeros(shape, dtype=_dtype(cfg), device=device),
                length=0))
            conv.append(None)
            ssm.append(None)
        else:
            c, s = init_states(cfg, batch, device=device)
            kv.append(None)
            conv.append(c)
            ssm.append(s)
    return JambaCache(kv=kv, conv=conv, ssm=ssm, length=0)


def decode_step(cfg: ModelConfig, params: Jamba, cache: JambaCache,
                token: torch.Tensor, pos: int):
    """One decode step.  token: [B, 1] int; pos: int.  An attention layer
    writes slot ``min(pos, window - 1)`` of its KV (the window caps it at
    long context) in place; the Mamba layers return new states.

    Returns (logits [B, 1, Vp], cache)."""
    x = params.embed[token]
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    new_kv, new_conv, new_ssm = [], [], []
    for l, p in enumerate(params.layers):
        h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
        if is_attn_layer(cfg, l):
            q, k_new, v_new = gqa_project(h, p, cfg, positions=positions)
            lc = cache.kv[l]
            slot = min(pos, lc.k.shape[1] - 1)  # windowed KV at long context
            attn, nlc = decode_attention(q, lc, k_new, v_new, pos=slot)
            mix = attn.reshape(b, 1, -1) @ p["w_o"]
            new_kv.append(nlc)
            new_conv.append(None)
            new_ssm.append(None)
        else:
            mix, nc, ns = mamba_block(
                cfg, h, p["mamba"], conv_state=cache.conv[l],
                ssm_state=cache.ssm[l], decode=True)
            new_kv.append(None)
            new_conv.append(nc)
            new_ssm.append(ns)
        x = x + mix
        x = x + _ffn(cfg, l, x, p)[0]
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_fn(cfg, params, x), JambaCache(
        kv=new_kv, conv=new_conv, ssm=new_ssm, length=cache.length + 1)
