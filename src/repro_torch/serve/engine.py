"""Batched serving engine over the continuous-batching scheduler.

Port of ``repro/serve/engine.py``.  ``Engine.generate`` keeps the seed
contract, ``[B, T] -> [B, max_new]`` greedy continuation, and routes the
transformer families through the paged
:class:`~repro_torch.serve.scheduler.ServeScheduler` (one lane per row,
pool sized to the call).  Families without a paged decode path (rwkv,
jamba, whisper) keep ``_generate_legacy``, the one-shot loop over a
static cache, which is also the paged path's exactness oracle.

Long-lived serving should use :meth:`Engine.make_scheduler` directly:
submit requests as they arrive, call ``step``/``run``, and let paging and
admission do their work across requests of different lengths.

The engine runs on the card unless it is given ``device="cpu"``; with no
card and no device it raises.  The weights must already be on that
device.  The reference's ``jit`` caches and donated pool buffer have no
counterpart: torch runs eagerly, and the caches are written in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..models.api import get_model
from ..models.config import ModelConfig
from ..models.layers import KVCache
from ..mpc.field import resolve_device
from .scheduler import ServeScheduler, check_params_device


def _pad_cache(cache, extra: int):
    """Grow every KV cache in ``cache`` along its sequence dim (``[..., S,
    H, D]``) by ``extra`` slots, walking lists, tuples and dataclasses as
    the reference does (jamba keeps a list of per-layer caches, whisper a
    list inside a dataclass).  What holds no KV cache (a recurrent state
    of constant size, an encoder output) comes back as the same object."""
    if isinstance(cache, KVCache):
        def pad(x):
            return F.pad(x, (0, 0, 0, 0, 0, extra))

        return KVCache(k=pad(cache.k), v=pad(cache.v), length=cache.length)
    if isinstance(cache, (list, tuple)):
        items = [_pad_cache(o, extra) for o in cache]
        same = all(a is b for a, b in zip(items, cache, strict=True))
        return cache if same else type(cache)(items)
    if dataclasses.is_dataclass(cache) and not isinstance(cache, type):
        fields = {f.name: getattr(cache, f.name)
                  for f in dataclasses.fields(cache)}
        grown = {k: _pad_cache(v, extra) for k, v in fields.items()}
        same = all(grown[k] is v for k, v in fields.items())
        return cache if same else type(cache)(**grown)
    return cache


class Engine:
    """Greedy generation for one model on one device."""

    def __init__(self, cfg: ModelConfig, params, *, device=None,
                 block_size: int = 16):
        self.cfg, self.params, self.block_size = cfg, params, block_size
        self.device = resolve_device(device)
        check_params_device(params, self.device)
        self.model = get_model(cfg)
        self._paged = hasattr(self.model, "decode_step_paged")

    def make_scheduler(self, *, lanes: int = 4,
                       n_blocks: Optional[int] = None,
                       max_len: int = 512) -> ServeScheduler:
        """A continuous-batching scheduler for this engine's model."""
        return ServeScheduler(self.cfg, self.params, lanes=lanes,
                              block_size=self.block_size, n_blocks=n_blocks,
                              max_len=max_len, device=self.device)

    def _tokens(self, prompt) -> torch.Tensor:
        return torch.as_tensor(prompt, dtype=torch.int64, device=self.device)

    def generate(self, prompt, max_new: int,
                 embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """prompt: [B, T] int -> [B, max_new] greedy continuation (int64,
        on the engine's device)."""
        prompt = self._tokens(prompt)
        b = prompt.shape[0]
        if max_new < 1:  # honor the [B, max_new] contract without a prefill
            return torch.zeros((b, 0), dtype=torch.int64, device=self.device)
        if not self._paged:
            return self._generate_legacy(prompt, max_new, embeds)
        need = prompt.shape[1] + (
            embeds.shape[1] if embeds is not None else 0) + max_new - 1
        sched = self.make_scheduler(lanes=b, max_len=need)
        rids = [sched.submit(prompt[i:i + 1], max_new,
                             embeds=None if embeds is None
                             else embeds[i:i + 1])
                for i in range(b)]
        done = sched.run()
        return torch.stack([torch.from_numpy(done[r]) for r in rids]).to(
            self.device)

    def _generate_legacy(self, prompt, max_new: int,
                         embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Seed one-shot loop: static cache, lock-step decode."""
        prompt = self._tokens(prompt)
        logits, cache = self.model.prefill(self.cfg, self.params, prompt,
                                           embeds=embeds)
        # the prefill cache already holds the prompt (+ embeds) positions
        # and the first token comes straight from the prefill logits, so
        # only the max_new - 1 decode steps below need cache slots
        # (positions base .. base + max_new - 2)
        cache = _pad_cache(cache, max_new - 1)
        tok = logits[:, -1:].argmax(dim=-1)
        # the first decode position is the count of positions the prefill
        # cache holds: the prompt, and the embeds where they are decoder
        # positions (vlm).  whisper's embeds are encoder frames and hold no
        # slot of its self-KV; the reference counts them anyway (ROADMAP
        # §3, "Facts about the reference")
        base = cache.length
        out = [tok]
        for i in range(max_new - 1):
            logits, cache = self.model.decode_step(self.cfg, self.params,
                                                   cache, tok, base + i)
            tok = logits[:, -1:].argmax(dim=-1)
            out.append(tok)
        return torch.cat(out, dim=1)
