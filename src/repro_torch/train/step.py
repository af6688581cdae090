"""Training step factory: loss → grads → (optional microbatch accumulation)
→ AdamW+WSD update.

Port of ``repro/train/step.py`` for one card.  ``make_train_step`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
as the reference's does; the step updates the weights and the optimizer's
moments in place (see :mod:`repro_torch.optim.adamw`) and returns the same
objects.  ``metrics`` holds ``loss``, ``lr`` and ``gnorm`` as 0-d device
tensors: nothing in the step waits for the card.  The reference's
inter-pod int8 gradient compression (``parallel/compressed.py``) belongs
to multi-card training, ROADMAP queue 1, item 16; its step does not call
it either.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models.api import get_model
from ..models.config import ModelConfig
from ..optim.adamw import AdamW, AdamWState
from ..optim.schedule import wsd


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup: int = 100
    stable: int = 10_000
    decay: int = 1_000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    microbatches: int = 1        # grad-accumulation chunks over batch dim
    seq_chunk: int = 512         # xent chunking
    opt_dtype: str = "float32"   # AdamW state dtype


def make_optimizer(tc: TrainConfig) -> AdamW:
    return AdamW(weight_decay=tc.weight_decay, clip_norm=tc.clip_norm,
                 state_dtype=tc.opt_dtype)


# per-arch memory tuning: grad-accumulation so saved layer inputs fit HBM,
# bf16 optimizer state for the 235B config (the reference's table)
ARCH_TRAIN_OVERRIDES = {
    "qwen3-moe-235b-a22b": TrainConfig(microbatches=1, opt_dtype="bfloat16"),
    "jamba-v0.1-52b": TrainConfig(microbatches=4),
    "minicpm-2b": TrainConfig(microbatches=2),
    "granite-3-2b": TrainConfig(microbatches=2),
    "phi-3-vision-4.2b": TrainConfig(microbatches=4),
    "rwkv6-1.6b": TrainConfig(microbatches=2),
}


def make_train_step(cfg: ModelConfig, tc: TrainConfig) -> Callable:
    model = get_model(cfg)
    opt = make_optimizer(tc)

    def loss_of(params, batch):
        return model.loss_fn(
            cfg, params, batch["tokens"], batch["targets"],
            seq_chunk=tc.seq_chunk, embeds=batch.get("embeds"))

    def grads_of(params, batch, weights):
        loss = loss_of(params, batch)
        grads = torch.autograd.grad(loss, weights, allow_unused=True)
        return loss, [torch.zeros_like(w) if g is None else g
                      for w, g in zip(weights, grads, strict=True)]

    def train_step(params, opt_state: AdamWState, batch):
        named = dict(params.named_parameters())
        names, weights = list(named), list(named.values())
        mb = tc.microbatches
        if mb > 1:
            # the reference's scan over microbatches: fp32 sums of the
            # losses and the gradients, then their means
            loss = torch.zeros((), dtype=torch.float32, device=weights[0].device)
            acc = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                   for w in weights]
            for i in range(mb):
                micro = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                         for k, v in batch.items()}
                part, grads = grads_of(params, micro, weights)
                loss = loss + part.detach()
                for a, g in zip(acc, grads, strict=True):
                    a.add_(g)
            loss = loss / mb
            # in place: a second fp32 copy of every gradient would not fit
            # beside jamba's weights and moments on one card
            grads = [a.div_(mb) for a in acc]
        else:
            loss, grads = grads_of(params, batch, weights)
            loss = loss.detach()
        lr = wsd(opt_state.step, peak_lr=tc.peak_lr, warmup=tc.warmup,
                 stable=tc.stable, decay=tc.decay, floor=tc.peak_lr * 0.1)
        params, opt_state, gnorm = opt.update(dict(zip(names, grads, strict=True)),
                                              opt_state, params, lr)
        return params, opt_state, {"loss": loss, "lr": lr, "gnorm": gnorm}

    return train_step


def init_train_state(cfg: ModelConfig, tc: TrainConfig, key, *, device):
    """Trainable weights drawn from ``key`` (an int seed or a
    ``torch.Generator``) on ``device``, and the optimizer's zero state."""
    model = get_model(cfg)
    params = model.init_params(cfg, key, device=device).requires_grad_(True)
    opt_state = make_optimizer(tc).init(params)
    return params, opt_state
