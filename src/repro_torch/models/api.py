"""Unified model facade: one namespace per family with a common surface.

    model = get_model(cfg)
    params = model.init_params(cfg, seed, device=...)
    hidden, aux = model.forward(cfg, params, tokens, embeds=...)
    cache = model.init_cache(cfg, batch, max_len, device=...)
    logits, cache = model.decode_step(cfg, params, cache, token, pos)

Port of ``repro/models/api.py``.  The dense, moe, vlm and ssm (RWKV-6)
families are ported; the others raise ``NotImplementedError`` naming their
ROADMAP item.
"""
from __future__ import annotations

import types

from . import rwkv, transformer
from .config import ModelConfig

_FAMILY_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "ssm": rwkv,
}

_NOT_PORTED = {
    "hybrid": "the jamba family (models/jamba.py, models/ssm.py) is not "
              "ported yet (ROADMAP queue 1, item 12)",
    "encdec": "the whisper family (models/whisper.py) is not ported yet "
              "(ROADMAP queue 1, item 12)",
}


def get_model(cfg: ModelConfig) -> types.ModuleType:
    try:
        return _FAMILY_MODULES[cfg.family]
    except KeyError:
        if cfg.family in _NOT_PORTED:
            raise NotImplementedError(_NOT_PORTED[cfg.family]) from None
        raise ValueError(f"unknown family {cfg.family!r}") from None
