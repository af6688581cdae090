"""RWKV-6 "Finch" LM (attention-free, data-dependent decay), arXiv:2404.05892.

Port of ``repro/models/rwkv.py``.  Block = time-mix (token shift,
r/k/v/g projections, LoRA-style dynamic decay ``w_t``, WKV recurrence) +
channel-mix (token shift, squared-ReLU FFN).  Weights are an
:class:`RWKV` module holding one :class:`Layer` per block, named as in
the JAX ``init_params`` tree.

The WKV core of ``forward`` and ``prefill`` is
:func:`~repro_torch.kernels.rwkv6.rwkv6` on every device: the kernel on
the card, its plain version on the CPU.  It returns the final state that
seeds decode, so ``cfg.wkv_chunk`` is not read: the reference's chunked
form is another schedule of the same function.  ``decode_step`` keeps the
reference's inline fp32 update, as the JAX decode has no kernel either,
and writes the cache in place.

:func:`loss_fn` trains on either device: under autograd the WKV runs
through :class:`~repro_torch.kernels.rwkv6.WKV6`, whose backward is the
hand-written ``rwkv6_bwd`` kernel on the card and its plain version on
the CPU.

Decode carries (shift_tm, shift_cm, wkv_state) per layer: constant memory,
so the family has no paged decode path and serves through
``Engine._generate_legacy``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.rwkv6 import rwkv6
from ..mpc.errors import ShapeContractError
from ..mpc.field import generator
from .config import ModelConfig
from .layers import rms_norm
from .transformer import Layer as _Layer
from .transformer import Transformer, chunked_xent, logits_fn, run_layers

HEAD_K = 64  # RWKV-6 head size

LAYER_KEYS = ("tm_norm", "cm_norm", "mu_r", "mu_k", "mu_v", "mu_w", "mu_g",
              "w_r", "w_k", "w_v", "w_g", "w_o", "w_base", "dw_a", "dw_b",
              "u_bonus", "wkv_norm", "cm_mu", "cm_wk", "cm_wr", "cm_wv")


class Layer(_Layer):
    """One RWKV block's weights, named as in the JAX tree."""

    KEYS = LAYER_KEYS


class RWKV(Transformer):
    """The whole model's weights: ``embed [Vp, D]``, ``layers``,
    ``final_norm [D]`` and ``lm_head [D, Vp]`` (never tied)."""


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def n_heads(cfg: ModelConfig) -> int:
    if cfg.d_model % HEAD_K:
        raise ShapeContractError(
            f"rwkv needs d_model divisible by {HEAD_K}: got {cfg.d_model}")
    return cfg.d_model // HEAD_K


# ------------------------------------------------------------------- init --
def init_params(cfg: ModelConfig, key, *, device) -> RWKV:
    """Random weights as the JAX ``init_params`` draws them (normal, scaled
    by ``fan_in ** -0.5``; norms at 1, token-shift mixes at 0.5, decay base
    at -6), from ``key`` (an int seed or a ``torch.Generator``) on
    ``device``.  Torch and JAX draw different numbers; tests carry JAX's
    weights across with :func:`~repro_torch.models.convert.params_from_numpy`."""
    dev = torch.device(device)
    g = generator(key, dev)
    dt = _dtype(cfg)
    d, h = cfg.d_model, n_heads(cfg)
    lora = max(32, d // 64)

    def mk(shape, scale_dim=d):
        x = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
        return (x * scale_dim ** -0.5).to(dt)

    def full(value, n=d):
        return torch.full((n,), value, dtype=dt, device=dev)

    layers = [Layer({
        "tm_norm": full(1.0),
        "cm_norm": full(1.0),
        "mu_r": full(0.5),
        "mu_k": full(0.5),
        "mu_v": full(0.5),
        "mu_w": full(0.5),
        "mu_g": full(0.5),
        "w_r": mk((d, d)),
        "w_k": mk((d, d)),
        "w_v": mk((d, d)),
        "w_g": mk((d, d)),
        "w_o": mk((d, d)),
        "w_base": full(-6.0),
        "dw_a": mk((d, lora)),
        "dw_b": mk((lora, d), lora),
        "u_bonus": mk((h, HEAD_K), 1),
        "wkv_norm": full(1.0),
        "cm_mu": full(0.5),
        "cm_wk": mk((d, cfg.d_ff)),
        "cm_wr": mk((d, d)),
        "cm_wv": mk((cfg.d_ff, d), cfg.d_ff),
    }) for _ in range(cfg.n_layers)]
    vp = cfg.padded_vocab()
    return RWKV(mk((vp, d)), layers, full(1.0), mk((d, vp)))


# ------------------------------------------------------------ block pieces --
def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1} with ``prev`` as the t=0 predecessor [B, D]."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _time_mix_inputs(cfg: ModelConfig, x: torch.Tensor, prev: torch.Tensor,
                     p: Layer):
    """The WKV operands of one time-mix: r, k, v, w as ``[B, T, H, 64]``
    in x's dtype, and the gate g ``[B, T, D]``."""
    b, t, _ = x.shape
    h = n_heads(cfg)
    xx = _shift(x, prev)

    def mix(mu):
        return x + (xx - x) * mu

    def heads(y):
        return y.reshape(b, t, h, HEAD_K)

    r = mix(p["mu_r"]) @ p["w_r"]
    k = mix(p["mu_k"]) @ p["w_k"]
    v = mix(p["mu_v"]) @ p["w_v"]
    g = F.silu(mix(p["mu_g"]) @ p["w_g"])
    xw = mix(p["mu_w"])
    w = p["w_base"] + torch.tanh(xw @ p["dw_a"]) @ p["dw_b"]  # [B, T, D]
    return heads(r), heads(k), heads(v), heads(w), g


def _time_mix(cfg: ModelConfig, x: torch.Tensor, prev: torch.Tensor, p: Layer
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out [B,T,D], last_x [B,D], final wkv state [B,H,K,V] fp32):
    the reference's ``return_state=True`` form, which the kernel always
    gives."""
    b, t, d = x.shape
    r, k, v, w, g = _time_mix_inputs(cfg, x, prev, p)
    out, state = rwkv6(r, k, v, w, p["u_bonus"])
    out = out.reshape(b, t, d).to(x.dtype)  # wkv core runs fp32
    out = rms_norm(out, p["wkv_norm"], cfg.norm_eps) * g
    return out @ p["w_o"], x[:, -1], state


def _channel_mix(x: torch.Tensor, prev: torch.Tensor, p: Layer):
    xx = _shift(x, prev)
    xk = x + (xx - x) * p["cm_mu"]
    k = torch.square(torch.relu(xk @ p["cm_wk"]))
    r = torch.sigmoid(x @ p["cm_wr"])
    return r * (k @ p["cm_wv"]), x[:, -1]


def _layer(cfg: ModelConfig, x: torch.Tensor, p: Layer):
    """One block from zero token-shift state; returns the new residual, the
    block's input and its mid residual (the next decode step's shift
    states) and the final wkv state."""
    zero_prev = torch.zeros_like(x[:, 0])
    xin = x
    h = rms_norm(x, p["tm_norm"], cfg.norm_eps)
    tm, _, wkv_state = _time_mix(cfg, h, zero_prev, p)
    x = x + tm
    x_mid = x
    h = rms_norm(x, p["cm_norm"], cfg.norm_eps)
    cm, _ = _channel_mix(h, zero_prev, p)
    return x + cm, xin, x_mid, wkv_state


# ---------------------------------------------------------------- forward --
def forward(cfg: ModelConfig, params: RWKV, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: [B, T] int -> (hidden [B, T, D], aux loss 0)."""

    def body(x, aux, lp):
        return _layer(cfg, x, lp)[0], aux

    x, aux = run_layers(cfg, body, params.embed[tokens], list(params.layers))
    return rms_norm(x, params.final_norm, cfg.norm_eps), aux


def loss_fn(cfg: ModelConfig, params: RWKV, tokens, targets, *,
            seq_chunk: int = 512, embeds=None) -> torch.Tensor:
    """Next-token cross entropy, sequence-chunked softmax (no aux)."""
    hidden, _ = forward(cfg, params, tokens)
    return chunked_xent(cfg, params, hidden, targets, seq_chunk, logits_fn)


@dataclasses.dataclass
class RWKVCache:
    """Recurrent decode state: O(1) in the sequence length."""
    shift_tm: torch.Tensor   # [L, B, D]
    shift_cm: torch.Tensor   # [L, B, D]
    wkv: torch.Tensor        # [L, B, H, K, V] fp32
    length: int


def prefill(cfg: ModelConfig, params: RWKV, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None):
    """Serving prefill: last logits + recurrent states (O(1) cache size)."""
    x = params.embed[tokens]
    s_tm, s_cm, wkv = [], [], []
    for lp in params.layers:
        x, xin, x_mid, state = _layer(cfg, x, lp)
        s_tm.append(xin[:, -1])
        s_cm.append(x_mid[:, -1])
        wkv.append(state)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = logits_fn(cfg, params, x[:, -1:])
    cache = RWKVCache(shift_tm=torch.stack(s_tm), shift_cm=torch.stack(s_cm),
                      wkv=torch.stack(wkv), length=tokens.shape[1])
    return logits, cache


# ----------------------------------------------------------------- decode --
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device) -> RWKVCache:
    """Zero states on ``device``; ``max_len`` is unused (constant memory)."""
    dt = _dtype(cfg)
    h = n_heads(cfg)
    L, d = cfg.n_layers, cfg.d_model
    return RWKVCache(
        shift_tm=torch.zeros((L, batch, d), dtype=dt, device=device),
        shift_cm=torch.zeros((L, batch, d), dtype=dt, device=device),
        wkv=torch.zeros((L, batch, h, HEAD_K, HEAD_K), dtype=torch.float32,
                        device=device),
        length=0)


def decode_step(cfg: ModelConfig, params: RWKV, cache: RWKVCache,
                token: torch.Tensor, pos: int):
    """O(1) decode: one state update per layer, no KV growth.  token:
    [B, 1] int; ``pos`` is unused (the state knows where it is).

    Returns (logits [B, 1, Vp], cache); the cache's tensors are updated in
    place (the reference returns new arrays)."""
    x = params.embed[token][:, 0]            # [B, D]
    b, d = x.shape
    h = n_heads(cfg)
    for li, lp in enumerate(params.layers):
        xin = x
        hh = rms_norm(xin, lp["tm_norm"], cfg.norm_eps)
        s_tm_n = rms_norm(cache.shift_tm[li], lp["tm_norm"], cfg.norm_eps)

        def mix(mu, hh=hh, s_tm_n=s_tm_n):
            return hh + (s_tm_n - hh) * mu

        r = mix(lp["mu_r"]) @ lp["w_r"]
        k = mix(lp["mu_k"]) @ lp["w_k"]
        v = mix(lp["mu_v"]) @ lp["w_v"]
        g = F.silu(mix(lp["mu_g"]) @ lp["w_g"])
        xw = mix(lp["mu_w"])
        w = lp["w_base"] + torch.tanh(xw @ lp["dw_a"]) @ lp["dw_b"]
        rh, kh, vh, wh = (y.reshape(b, h, HEAD_K).float() for y in (r, k, v, w))
        kv = kh[..., :, None] * vh[..., None, :]
        u = lp["u_bonus"].float()
        st = cache.wkv[li]
        out = torch.einsum("bhk,bhkv->bhv", rh, st + u[None, ..., None] * kv)
        cache.wkv[li] = st * torch.exp(-torch.exp(wh))[..., None] + kv
        tm = rms_norm(out.reshape(b, d).to(x.dtype), lp["wkv_norm"],
                      cfg.norm_eps) * g
        x = xin + tm @ lp["w_o"]

        hh2 = rms_norm(x, lp["cm_norm"], cfg.norm_eps)
        s_cm_n = rms_norm(cache.shift_cm[li], lp["cm_norm"], cfg.norm_eps)
        xk = hh2 + (s_cm_n - hh2) * lp["cm_mu"]
        kk = torch.square(torch.relu(xk @ lp["cm_wk"]))
        rr = torch.sigmoid(hh2 @ lp["cm_wr"])
        cache.shift_tm[li] = xin
        cache.shift_cm[li] = x         # post-tm, pre-cm: the cm shift state
        x = x + rr * (kk @ lp["cm_wv"])
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = logits_fn(cfg, params, x[:, None])
    return logits, RWKVCache(shift_tm=cache.shift_tm, shift_cm=cache.shift_cm,
                             wkv=cache.wkv, length=cache.length + 1)
