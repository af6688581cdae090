"""Training step factory: loss → grads → (optional microbatch accumulation)
→ AdamW+WSD update.

Port of ``repro/train/step.py`` for one card.  ``make_train_step`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
as the reference's does; the step updates the weights and the optimizer's
moments in place (see :mod:`repro_torch.optim.adamw`) and returns the same
objects.  ``metrics`` holds ``loss``, ``lr`` and ``gnorm`` as 0-d device
tensors: nothing in the step waits for the card.

With ``mesh`` (a ``torch.distributed`` ``DeviceMesh`` over ``("pod",
"data", "model")``, :func:`repro_torch.launch.mesh.process_mesh`) the
same step runs on every rank on that rank's rows, with the parameters
laid out and the gradients reduced as
:class:`repro_torch.parallel.fsdp.Layout` says: FSDP over ``data``, the
mean over every rank before AdamW, and with ``compress_pod`` the int8
error-feedback reduction over ``pod`` (``parallel/compressed.py``) that
the reference names as its inter-pod option, its residuals carried in
``opt_state.feedback`` (so a checkpoint holds them).  Without a mesh it
is the one-card step, untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .. import spans
from ..models.api import get_model
from ..models.config import ModelConfig
from ..optim.adamw import AdamW, AdamWState
from ..optim.schedule import wsd
from ..parallel.fsdp import Layout


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


def make_train_step(cfg: ModelConfig, tc: TrainConfig, *, mesh=None,
                    compress_pod: bool = False) -> Callable:
    model = get_model(cfg)
    opt = make_optimizer(tc)
    layout = None
    if mesh is not None:
        layout = Layout.for_config(cfg, mesh, compress_pod=compress_pod)
    elif compress_pod:
        raise ValueError("compress_pod needs a mesh with a 'pod' axis")

    def loss_of(params, batch):
        return model.loss_fn(
            cfg, params, batch["tokens"], batch["targets"],
            seq_chunk=tc.seq_chunk, embeds=batch.get("embeds"))

    def forward(params, batch, i):
        """Microbatch ``i``'s loss, sliced from the batch inside its span."""
        with spans.span("train.forward", micro=i):
            mb = tc.microbatches
            if mb > 1:
                batch = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                         for k, v in batch.items()}
            return loss_of(params, batch)

    def grads_of(loss, weights):
        grads = torch.autograd.grad(loss, weights, allow_unused=True)
        return [torch.zeros_like(w) if g is None else g
                for w, g in zip(weights, grads, strict=True)]

    def loss_and_grads(params, batch):
        """The mean loss, the weights' names and their gradients.  Every
        host step between the forward passes runs inside a backward span:
        the weights' listing and, over several microbatches (the
        reference's scan: fp32 sums of the losses and the gradients, then
        their means), the sums' set-up and the means."""
        mb = tc.microbatches
        for i in range(mb):
            part = forward(params, batch, i)
            with spans.span("train.backward", micro=i):
                if i == 0:
                    named = dict(params.named_parameters())
                    names, weights = list(named), list(named.values())
                    if mb == 1:
                        return part.detach(), names, grads_of(part, weights)
                    loss = torch.zeros((), dtype=torch.float32,
                                       device=weights[0].device)
                    acc = [torch.zeros(w.shape, dtype=torch.float32,
                                       device=w.device) for w in weights]
                grads = grads_of(part, weights)
                loss = loss + part.detach()
                for a, g in zip(acc, grads, strict=True):
                    a.add_(g)
                if i == mb - 1:
                    del grads    # their frees, too, belong to the backward
                    # in place: a second fp32 copy of every gradient would
                    # not fit beside jamba's weights and moments on one card
                    return loss / mb, names, [a.div_(mb) for a in acc]

    @spans.spanned("train.step")
    def train_step(params, opt_state: AdamWState, batch):
        gnorm = None
        if layout is not None:
            layout.unshard_(params)
        loss, names, grads = loss_and_grads(params, batch)
        feedback = opt_state.feedback
        if layout is not None:
            layout.reshard_(params)
            grads, loss, feedback = layout.reduce(names, grads, loss,
                                                  feedback)
            gnorm = layout.global_norm(names, grads)
        with spans.span("train.optimizer"):
            lr = wsd(opt_state.step, peak_lr=tc.peak_lr, warmup=tc.warmup,
                     stable=tc.stable, decay=tc.decay, floor=tc.peak_lr * 0.1)
            params, opt_state, gnorm = opt.update(
                dict(zip(names, grads, strict=True)),
                opt_state._replace(feedback=feedback), params, lr,
                gnorm=gnorm)
        return params, opt_state, {"loss": loss, "lr": lr, "gnorm": gnorm}

    train_step.layout = layout
    return train_step


def init_train_state(cfg: ModelConfig, tc: TrainConfig, key, *, device,
                     layout: Optional[Layout] = None):
    """Trainable weights drawn from ``key`` (an int seed or a
    ``torch.Generator``) on ``device``, and the optimizer's zero state.
    With ``layout`` (a multi-rank step's ``train_step.layout``) every rank
    draws the whole weights from the same seed and keeps its slices, and
    the moments take the slices' shapes; a ``compress_pod`` layout's
    residuals start at zero in ``opt_state.feedback``."""
    model = get_model(cfg)
    params = model.init_params(cfg, key, device=device).requires_grad_(True)
    if layout is not None:
        layout.shard_(params)
    opt_state = make_optimizer(tc).init(params)
    if layout is not None:
        opt_state = opt_state._replace(feedback=layout.zero_feedback(params))
    return params, opt_state
