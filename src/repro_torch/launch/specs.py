"""Per-cell tracing packages: abstract inputs (``meta`` tensors — never
allocated) + sharding trees for every (arch × shape × mesh) combination.

``build_cell`` returns everything ``dryrun.py`` needs to trace a cell:

* train cells  →  ``train_step(params, opt_state, batch)``
* prefill cells →  ``model.prefill(params, tokens[, embeds])``
* decode cells  →  ``model.decode_step(params, cache, token, pos)``

Port of ``repro/launch/specs.py``.  JAX's ``ShapeDtypeStruct`` is a
``meta`` tensor, ``jax.eval_shape(init_params)`` the family's
``init_params`` on ``device="meta"`` (and ``init_cache`` likewise), each
``NamedSharding`` the port's :class:`~repro_torch.parallel.sharding.
NamedSharding` ``(mesh, P)``, and a train cell's ``fn`` the port's
one-card :func:`~repro_torch.train.step.make_train_step`.  The port's
decode step takes the slot as an int: a decode cell writes the cache's
last slot (``seq_len - 1``), where the reference traces an abstract one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..models.api import get_model
from ..models.config import ModelConfig, ShapeConfig
from ..parallel.sharding import (
    DEFAULT_RULES,
    NamedSharding,
    P,
    infer_param_specs,
    mesh_shape,
    spec_for,
)
from ..train.step import (
    ARCH_TRAIN_OVERRIDES,
    TrainConfig,
    make_optimizer,
    make_train_step,
)


def _ns(mesh, spec):
    return NamedSharding(mesh, spec)


def sds(shape, dtype) -> torch.Tensor:
    """An abstract input: a ``meta`` tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device="meta")


# ----------------------------------------------------------- cache specs --
def _cache_leaf_spec(shape, mesh, cfg) -> P:
    """Heuristic logical axes for cache leaves (guarded by spec_for)."""
    sizes = mesh_shape(mesh)
    r = len(shape)
    if r <= 1:
        return P()
    if r == 5:
        if shape[2] >= shape[3]:   # [L, B, S, Hkv, D] stacked KV
            # prefer head TP; fall back to sequence sharding when heads
            # don't divide the axis (long-context KV sequence sharding)
            hd_ok = shape[3] % sizes.get("model", 1) == 0
            logical = (None, "batch", None if hd_ok else "seq_kv",
                       "kv_heads", None)
            rules = None if hd_ok else {"seq_kv": "model"}
            return spec_for(shape, logical, mesh, rules and
                            {**_default_rules(), **rules})
        # [L, B, H, K, V] rwkv wkv state
        return spec_for(shape, (None, "batch", "heads", None, None), mesh)
    if r == 4:                     # [B, S, Hkv, D] per-layer KV
        hd_ok = shape[2] % sizes.get("model", 1) == 0
        logical = ("batch", None if hd_ok else "seq_kv", "kv_heads", None)
        rules = None if hd_ok else {"seq_kv": "model"}
        return spec_for(shape, logical, mesh,
                        rules and {**_default_rules(), **rules})
    if r == 3:
        if shape[0] == cfg.n_layers:          # [L, B, D] rwkv shifts
            return spec_for(shape, (None, "batch", None), mesh)
        if shape[1] <= 8:                      # [B, d_conv-1, Di] conv state
            return spec_for(shape, ("batch", None, "ffn"), mesh)
        # [B, Di, N] ssm state / [B, S_enc, D] encoder output
        return spec_for(shape, ("batch", "ffn", None), mesh,
                        {**_default_rules(), "ffn": "model"})
    return spec_for(shape, ("batch",) + (None,) * (r - 1), mesh)


def _default_rules():
    return dict(DEFAULT_RULES)


def tree_map(fn, tree):
    """``fn`` over every tensor leaf of a cache or state tree (dataclasses,
    named tuples, mappings, lists; None and ints pass through), keeping its
    structure (a dataclass becomes a dict of its fields)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return {f.name: tree_map(fn, getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return tree


def tensor_leaves(tree) -> list:
    """The tensor leaves of a tree, in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def cache_shardings(cache, mesh, cfg):
    return tree_map(lambda l: _ns(mesh, _cache_leaf_spec(l.shape, mesh, cfg)),
                    cache)


# ------------------------------------------------------------- the cells --
@dataclasses.dataclass
class Cell:
    name: str
    fn: Callable
    args: tuple
    in_shardings: tuple
    donate_argnums: tuple = ()
    meta: dict = dataclasses.field(default_factory=dict)


def _batch_sds(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               with_targets: bool):
    b, t = shape.global_batch, shape.seq_len
    fp = cfg.frontend_positions if cfg.family == "vlm" else 0
    toks = t - fp if cfg.family == "vlm" else t
    dt = getattr(torch, cfg.dtype)
    out = {"tokens": sds((b, toks), torch.int32)}
    spec = {"tokens": _ns(mesh, spec_for((b, toks), ("batch", None), mesh))}
    if with_targets:
        out["targets"] = sds((b, toks), torch.int32)
        spec["targets"] = spec["tokens"]
    if cfg.family == "vlm":
        out["embeds"] = sds((b, fp, cfg.d_model), dt)
        spec["embeds"] = _ns(
            mesh, spec_for((b, fp, cfg.d_model), ("batch", None, None), mesh))
    if cfg.family == "encdec":
        out["embeds"] = sds((b, t, cfg.d_model), dt)
        spec["embeds"] = _ns(
            mesh, spec_for((b, t, cfg.d_model), ("batch", None, None), mesh))
    return out, spec


def params_package(cfg: ModelConfig, mesh, rules: Optional[dict] = None):
    """``(meta weights, {name: NamedSharding})``."""
    model = get_model(cfg)
    p_sds = model.init_params(cfg, 0, device="meta")
    p_spec = infer_param_specs(p_sds, mesh, rules)
    p_shard = {name: _ns(mesh, s) for name, s in p_spec.items()}
    return p_sds, p_shard


def activation_rules(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """Per-cell logical-rule overrides.

    Archs whose q-head count doesn't divide the TP axis (smollm 15H,
    minicpm 36H, whisper 12H) would otherwise *replicate* attention across
    the axis.  For those we switch train/prefill to **sequence parallelism
    + pure FSDP**: activations shard (batch × seq), weights shard only on
    their FSDP dim (gathered per layer — weights ≪ activations at these
    widths), no tensor parallelism at all.  Decode relies on KV-sequence
    sharding instead (cache_shardings).
    """
    mp = mesh_shape(mesh).get("model", 1)
    rules: dict = {}
    if shape.kind == "decode":
        # serving holds no optimizer state: if TP-sharded weights fit HBM,
        # drop FSDP so no per-token weight all-gathers
        param_bytes_tp = cfg.param_count() * 2 / mp
        if param_bytes_tp <= 8e9:
            rules["p_fsdp"] = None
        if cfg.n_kv_heads and cfg.n_kv_heads % mp != 0:
            # KV-sequence-sharded decode attention (cache never re-gathers)
            rules["seq_kv"] = "model"
            rules["kv_heads"] = None
    has_attention = cfg.family in ("dense", "moe", "vlm", "encdec", "hybrid")
    if (has_attention and cfg.n_heads and cfg.n_heads % mp != 0
            and shape.kind in ("train", "prefill")):
        rules.update({
            "seq": "model",
            "heads": None, "kv_heads": None,
            "ffn": None, "experts": None,
            "p_tp": None,          # no TP on block params: FSDP-only
            # vocab stays "model": the lm_head keeps vocab TP (loss gathers
            # seq shards first)
            "attn_q_chunk": shape.seq_len,  # one q chunk: q stays sharded
        })
    return rules


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               tc: Optional[TrainConfig] = None) -> Cell:
    model = get_model(cfg)
    tc = tc or ARCH_TRAIN_OVERRIDES.get(cfg.name, TrainConfig())
    rules = activation_rules(cfg, shape, mesh)
    p_sds, p_shard = params_package(cfg, mesh, rules)

    if shape.kind == "train":
        p_sds.requires_grad_(True)
        o_sds = make_optimizer(tc).init(p_sds)
        o_shard = type(o_sds)(step=_ns(mesh, P()), mu=dict(p_shard),
                              nu=dict(p_shard))
        batch, b_shard = _batch_sds(cfg, shape, mesh, with_targets=True)
        fn = make_train_step(cfg, tc)
        return Cell(
            name=f"{cfg.name}:{shape.name}",
            fn=fn, args=(p_sds, o_sds, batch),
            in_shardings=(p_shard, o_shard, b_shard),
            donate_argnums=(0, 1),
            meta={"kind": "train", "rules": rules},
        )

    if shape.kind == "prefill":
        batch, b_shard = _batch_sds(cfg, shape, mesh, with_targets=False)

        if "embeds" in batch:
            def fn(p, toks, emb):
                return model.prefill(cfg, p, toks, embeds=emb)
            args = (p_sds, batch["tokens"], batch["embeds"])
            shards = (p_shard, b_shard["tokens"], b_shard["embeds"])
        else:
            def fn(p, toks):
                return model.prefill(cfg, p, toks)
            args = (p_sds, batch["tokens"])
            shards = (p_shard, b_shard["tokens"])
        return Cell(name=f"{cfg.name}:{shape.name}", fn=fn, args=args,
                    in_shardings=shards, meta={"kind": "prefill", "rules": rules})

    # decode: one token against a seq_len cache
    b, s = shape.global_batch, shape.seq_len
    cache_sds = model.init_cache(cfg, b, s, device="meta")
    c_shard = cache_shardings(cache_sds, mesh, cfg)
    token = sds((b, 1), torch.int32)
    t_shard = _ns(mesh, spec_for((b, 1), ("batch", None), mesh))

    def fn(p, c, tok, pp):
        return model.decode_step(cfg, p, c, tok, pp)

    return Cell(
        name=f"{cfg.name}:{shape.name}",
        fn=fn, args=(p_sds, cache_sds, token, s - 1),
        in_shardings=(p_shard, c_shard, t_shard, _ns(mesh, P())),
        donate_argnums=(1,),
        meta={"kind": "decode", "rules": rules},
    )
