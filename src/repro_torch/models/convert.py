"""Carry the JAX package's weights into the port.

``params_from_numpy(cfg, tree, device=...)`` takes the tree that the JAX
family's ``init_params`` returns, with every leaf as a numpy array
(``jax.tree.map(np.asarray, params)``), and builds the port's module for
``cfg.family``: a :class:`~repro_torch.models.transformer.Transformer`,
an :class:`~repro_torch.models.rwkv.RWKV`, a
:class:`~repro_torch.models.jamba.Jamba` or a
:class:`~repro_torch.models.whisper.Whisper`.  The dense, moe, vlm and ssm
trees stack their layers ``[L, ...]``; those arrays are cut into one layer
module each.  The hybrid and encdec trees hold lists of per-layer dicts
(nested: jamba's ``"mamba"`` block, whisper's ``{"scale", "bias"}``
norms), which keep their shape.  ``trainable=True`` gives weights that
take gradients (serving's are frozen).  :func:`to_jax_tree` goes the other
way: a mapping of the port's parameter names to tensors (its weights, or
their gradients in the same order) as the JAX tree, stacked ``[L, ...]``
where JAX stacks, so tests compare the two leaf by leaf.  This module has
no counterpart in the JAX package; it exists so that tests can run both
packages on the same weights.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from . import jamba, rwkv, transformer, whisper
from .api import get_model
from .config import ModelConfig


def tensor_from_numpy(x: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``.  JAX's bf16 arrives as
    ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses: its bits
    go across as ``uint16`` and are viewed as ``torch.bfloat16``."""
    x = np.ascontiguousarray(x)
    if not x.flags.writeable:   # JAX hands out read-only views
        x = x.copy()
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


def params_from_numpy(cfg: ModelConfig, tree: Mapping, *, device,
                      trainable: bool = False):
    """The port's weights from the JAX ``init_params`` tree (numpy
    leaves), on ``device``, as the module of ``cfg.family``; a family
    that is not ported raises as :func:`~repro_torch.models.api.get_model`
    does.  A MoE config's blocks become
    :class:`~repro_torch.models.transformer.MoELayer` s, the router and
    expert weights carried with the attention weights.  Frozen unless
    ``trainable``."""
    return _params_from_numpy(cfg, tree, device).requires_grad_(trainable)


def _params_from_numpy(cfg: ModelConfig, tree: Mapping, device):
    family = get_model(cfg)
    if family in (jamba, whisper):
        tree = _tensors(tree, device)
        return (jamba.build(cfg, tree) if family is jamba
                else whisper.Whisper(tree))
    model_cls = rwkv.RWKV if family is rwkv else transformer.Transformer
    layer_cls = (rwkv.Layer if family is rwkv
                 else transformer.layer_class(cfg))
    stacked = tree["layers"]
    layers = [layer_cls({name: tensor_from_numpy(stacked[name][li], device)
                         for name in layer_cls.KEYS})
              for li in range(cfg.n_layers)]
    lm_head = tree.get("lm_head")
    return model_cls(
        tensor_from_numpy(tree["embed"], device), layers,
        tensor_from_numpy(tree["final_norm"], device),
        None if lm_head is None else tensor_from_numpy(lm_head, device))


def _tensors(tree, device):
    """The same tree with every numpy leaf a tensor on ``device``."""
    if isinstance(tree, Mapping):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device) for v in tree]
    return tensor_from_numpy(tree, device)


def to_jax_tree(cfg: ModelConfig, named: Mapping[str, torch.Tensor]) -> dict:
    """``{port parameter name: tensor}`` (``dict(model.named_parameters())``,
    or the gradients under the same names) as the JAX ``init_params`` tree
    of ``cfg.family`` with numpy fp32 leaves: a dotted name is a path
    (``layers.3.w_q``, ``enc_layers.0.norm1.scale``), and the dense, moe,
    vlm and ssm families' layers are stacked ``[L, ...]`` as JAX stacks
    them; the hybrid and encdec trees keep their per-layer lists."""
    tree: dict = {}
    for name, x in named.items():
        node, parts = tree, name.split(".")
        i = 0
        while i < len(parts) - 1:
            if parts[i + 1].isdigit():       # a list and its index
                seq = node.setdefault(parts[i], [])
                at = int(parts[i + 1])
                seq.extend({} for _ in range(at + 1 - len(seq)))
                node, i = seq[at], i + 2
            else:
                node, i = node.setdefault(parts[i], {}), i + 1
        # analysis: allow(host-sync): the JAX tree is numpy on the host
        node[parts[-1]] = x.detach().float().cpu().numpy()
    if get_model(cfg) not in (jamba, whisper):
        layers = tree["layers"]
        tree["layers"] = {k: np.stack([lp[k] for lp in layers])
                          for k in layers[0]}
    return tree
