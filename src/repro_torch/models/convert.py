"""Carry the JAX package's weights into the port.

``params_from_numpy(cfg, tree, device=...)`` takes the tree that
``repro.models.transformer.init_params`` returns, with every leaf as a
numpy array (``jax.tree.map(np.asarray, params)``), and builds the port's
:class:`~repro_torch.models.transformer.Transformer`: the stacked
``[L, ...]`` layer arrays are cut into one :class:`Layer` each.  This
module has no counterpart in the JAX package; it exists so that tests can
run both packages on the same weights.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .config import ModelConfig
from .transformer import LAYER_KEYS, MOE_TODO, Layer, Transformer


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


def params_from_numpy(cfg: ModelConfig, tree: Mapping, *, device) -> Transformer:
    """The port's weights from the JAX ``init_params`` tree (numpy
    leaves), on ``device``."""
    if cfg.moe is not None:
        raise NotImplementedError(MOE_TODO)
    stacked = tree["layers"]
    layers = [Layer({name: tensor_from_numpy(stacked[name][li], device)
                     for name in LAYER_KEYS})
              for li in range(cfg.n_layers)]
    lm_head = tree.get("lm_head")
    return Transformer(
        tensor_from_numpy(tree["embed"], device), layers,
        tensor_from_numpy(tree["final_norm"], device),
        None if lm_head is None else tensor_from_numpy(lm_head, device))
