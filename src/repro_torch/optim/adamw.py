"""Functional AdamW with global-norm clipping (port of
``repro/optim/adamw.py``).

The signature is the reference's: ``init(params) -> AdamWState`` and
``update(grads, state, params, lr) -> (params, state, gnorm)``.  Trees are
flat mappings of name to tensor (``dict(module.named_parameters())``, or
an ``nn.Module``, whose named parameters are taken); ``grads`` is such a
mapping or a sequence in the parameters' order.  The arithmetic is the
reference's, step for step, in fp32 whatever the parameter's dtype, and
the result is cast back to it.

Departure: JAX returns new arrays; the port writes the parameters and the
moments in place (a full-width model's AdamW state is four copies of its
weights) and returns the same objects.  The step counter stays a device
tensor, so the bias corrections and a schedule read from it cause no host
sync.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional, Sequence, Union

import torch
from torch import nn

from .. import spans

Tree = Union[nn.Module, Mapping[str, torch.Tensor]]


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32, 0-d, on the parameters' device
    mu: dict
    nu: dict
    # the error-feedback residuals of a ``compress_pod`` step, by name (see
    # ``repro_torch.train.step``); empty otherwise.  The update carries
    # them through; the step replaces the dict, never mutates it
    feedback: dict = {}


def _named(tree: Tree) -> dict:
    """``{name: tensor}`` of a module's parameters or of a mapping."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


def _leaves(tree) -> list:
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, Mapping):
        return list(tree.values())
    return list(tree)


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: str = "float32"   # bfloat16 halves the optimizer's memory

    def init(self, params: Tree) -> AdamWState:
        named = _named(params)
        dt = getattr(torch, self.state_dtype)

        def zeros():
            return {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                    for k, p in named.items()}

        device = next(iter(named.values())).device if named else None
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(self, grads: Union[Mapping[str, torch.Tensor],
                                  Sequence[torch.Tensor]],
               state: AdamWState, params: Tree, lr,
               gnorm: Optional[torch.Tensor] = None):
        """``gnorm``, when given, is the gradients' global norm as the
        caller computed it (a rank that holds slices of the gradients
        reduces their squares over the ranks first); else
        :func:`global_norm` of ``grads``."""
        named = _named(params)
        if not isinstance(grads, Mapping):
            grads = dict(zip(named, grads, strict=True))
        with spans.span("optim.clip_norm"):
            if gnorm is None:
                gnorm = global_norm(grads)
            if self.clip_norm is not None:
                scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            else:
                scale = None
        with spans.span("optim.adamw"):
            step = state.step + 1
            stepf = step.to(torch.float32)
            b1c = 1 - torch.pow(torch.tensor(self.b1, dtype=torch.float32,
                                             device=stepf.device), stepf)
            b2c = 1 - torch.pow(torch.tensor(self.b2, dtype=torch.float32,
                                             device=stepf.device), stepf)
            lr = torch.as_tensor(lr, dtype=torch.float32, device=stepf.device)
            for name, p in named.items():
                for pp, g, mu, nu in _pieces(p, grads[name], state.mu[name],
                                             state.nu[name]):
                    g32 = g.to(torch.float32)
                    if scale is not None:
                        g32 = g32 * scale
                    m32 = self.b1 * mu.to(torch.float32) + (1 - self.b1) * g32
                    n32 = (self.b2 * nu.to(torch.float32)
                           + (1 - self.b2) * g32 * g32)
                    delta = (m32 / b1c) / (torch.sqrt(n32 / b2c) + self.eps)
                    p32 = pp.to(torch.float32)
                    delta = delta + self.weight_decay * p32
                    pp.copy_(p32 - lr * delta)
                    mu.copy_(m32)
                    nu.copy_(n32)
        return params, state._replace(step=step), gnorm


# elements a weight's update takes at a time: its fp32 temporaries (about
# seven live at once) then stay near 2 GB on the largest weights, where one
# pass over jamba's [16, 4096, 14336] experts would hold about 25 GB
_PIECE = 1 << 26


def _pieces(p, g, mu, nu):
    """``(p, g, mu, nu)`` as flat views of at most ``_PIECE`` elements (the
    update is elementwise, so the pieces give its bits), or whole where a
    tensor cannot be viewed flat."""
    if p.numel() <= _PIECE or not all(x.is_contiguous() for x in (p, mu, nu)):
        return [(p, g, mu, nu)]
    return zip(p.view(-1).split(_PIECE), g.reshape(-1).split(_PIECE),
               mu.view(-1).split(_PIECE), nu.view(-1).split(_PIECE),
               strict=True)


def global_norm(tree) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf, in fp32, on the leaves'
    device."""
    leaves = _leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))
