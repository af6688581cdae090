"""Architecture registry + reduced (smoke-test) variants.

``get_config(id)`` returns the exact assigned config; ``reduced(cfg)``
shrinks layers/width/experts for 1-device CPU smoke tests while keeping the
family topology (GQA ratios, MoE top-k, hybrid interleave) intact.
"""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig, MoEConfig, SSMConfig, SHAPE_BY_NAME, SHAPES
from . import (
    granite_3_2b,
    jamba_52b,
    llama3_2_1b,
    minicpm_2b,
    olmoe_1b_7b,
    phi_3_vision,
    qwen3_moe_235b,
    rwkv6_1b6,
    smollm_360m,
    whisper_small,
)

ARCHS = {
    "minicpm-2b": minicpm_2b.CONFIG,
    "llama3.2-1b": llama3_2_1b.CONFIG,
    "granite-3-2b": granite_3_2b.CONFIG,
    "smollm-360m": smollm_360m.CONFIG,
    "olmoe-1b-7b": olmoe_1b_7b.CONFIG,
    "qwen3-moe-235b-a22b": qwen3_moe_235b.CONFIG,
    "phi-3-vision-4.2b": phi_3_vision.CONFIG,
    "rwkv6-1.6b": rwkv6_1b6.CONFIG,
    "jamba-v0.1-52b": jamba_52b.CONFIG,
    "whisper-small": whisper_small.CONFIG,
}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise ValueError(
            f"unknown arch {name!r}; known: {sorted(ARCHS)}") from None


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-reduced",
        n_layers=min(cfg.n_layers, 2 if cfg.family != "hybrid" else 8),
        d_model=128,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=(max(1, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1))
                    if cfg.n_heads else 0),
        d_ff=256,
        vocab=512,
        head_dim=32 if cfg.n_heads else None,
        dtype="float32",
        remat=False,
        frontend_positions=min(cfg.frontend_positions, 8),
        n_enc_layers=min(cfg.n_enc_layers, 2),
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=128,
            router_chunk=64)
    if cfg.ssm is not None or cfg.family in ("ssm", "hybrid"):
        kw["ssm"] = SSMConfig(d_state=8, d_conv=4, expand=2, chunk=16)
    return dataclasses.replace(cfg, **kw)


def applicable_shapes(cfg: ModelConfig):
    """The assigned shape cells valid for this arch (long_500k only for
    sub-quadratic families — skip documented in DESIGN.md)."""
    out = []
    for s in SHAPES:
        if s.name == "long_500k" and not cfg.subquadratic:
            continue
        out.append(s)
    return out


__all__ = ["ARCHS", "get_config", "reduced", "applicable_shapes",
           "SHAPES", "SHAPE_BY_NAME"]
