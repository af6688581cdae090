"""Unified model facade: one namespace per family with a common surface.

    model = get_model(cfg)
    params = model.init_params(cfg, seed, device=...)
    hidden, aux = model.forward(cfg, params, tokens, embeds=...)
    loss = model.loss_fn(cfg, params, tokens, targets, embeds=...)
    cache = model.init_cache(cfg, batch, max_len, device=...)
    logits, cache = model.decode_step(cfg, params, cache, token, pos)

Port of ``repro/models/api.py``: every family of the JAX package.
"""
from __future__ import annotations

import types

from . import jamba, rwkv, transformer, whisper
from .config import ModelConfig

_FAMILY_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "ssm": rwkv,
    "hybrid": jamba,
    "encdec": whisper,
}


def get_model(cfg: ModelConfig) -> types.ModuleType:
    try:
        return _FAMILY_MODULES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r}") from None
