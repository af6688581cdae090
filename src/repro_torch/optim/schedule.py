"""LR schedules. WSD (warmup–stable–decay) is the minicpm schedule
(arXiv:2404.06395): linear warmup → flat plateau → short sharp decay.

Port of ``repro/optim/schedule.py``: float32 functions of the step, which
may be a device tensor (the optimizer's step counter), so that reading the
rate causes no host sync.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def wsd(step, *, peak_lr: float, warmup: int, stable: int, decay: int,
        floor: float = 0.0) -> torch.Tensor:
    step = _step(step)
    warm = peak_lr * step / max(warmup, 1)
    decay_frac = (step - warmup - stable) / max(decay, 1)
    decayed = peak_lr * torch.pow(torch.tensor(floor / peak_lr,
                                               dtype=torch.float32,
                                               device=step.device),
                                  torch.clamp(decay_frac, 0.0, 1.0))
    peak = torch.full_like(step, peak_lr)
    lr = torch.where(step < warmup, warm,
                     torch.where(step < warmup + stable, peak, decayed))
    return torch.clamp(lr, min=0.0)


def cosine(step, *, peak_lr: float, warmup: int, total: int,
           floor_ratio: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = peak_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = floor_ratio + (1 - floor_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup, warm, peak_lr * cos)
