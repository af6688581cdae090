"""Continuous-batching serve scheduler.

Port of ``repro/serve/scheduler.py``: a step loop over a **fixed lane
pool**.

* A request is **admitted** into a free lane between decode steps: its
  prompt is prefilled (``[1, T]``, the flash kernel on the card), the KV is
  scattered into pool blocks handed out by the
  :class:`~repro_torch.serve.paging.BlockAllocator`, and its first token
  comes straight from the prefill logits.
* Every decode step runs ``decode_step_paged`` over ALL lanes, with
  per-lane positions and block tables.
* A finished request **retires** between steps, freeing its lane and its
  KV blocks for the next admission.

Idle lanes still flow through the decode step (their writes land in the
reserved null block, their outputs are discarded).  A lane whose next
token needs a KV block the pool cannot supply **stalls** (skips steps, KV
intact) until a retirement frees one; if every live lane is stalled the
pool is over-committed and :class:`~repro_torch.serve.paging.
OutOfBlocksError` surfaces.

Per-lane outputs equal the engine's one-shot loop
(``Engine._generate_legacy``): the paged decode masks pool padding to
exact softmax zeros.  The reference's ``jit``/``donate`` machinery has no
counterpart: torch runs eagerly and the pool is updated in place.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.api import get_model
from ..models.config import ModelConfig
from ..mpc.field import resolve_device
from .paging import NULL_BLOCK, BlockAllocator, OutOfBlocksError, write_prefill


@dataclasses.dataclass
class _Lane:
    """Host-side state of one occupied lane."""

    rid: int
    blocks: List[int]                 # pool blocks owned, in logical order
    pos: int                          # next KV write position
    remaining: int                    # decode steps left
    out: List[int]                    # emitted token ids
    stalled: bool = False


@dataclasses.dataclass
class _Waiting:
    rid: int
    prompt: torch.Tensor              # [1, T] int64 on the device
    max_new: int
    embeds: Optional[torch.Tensor]


def check_params_device(params, device: torch.device) -> None:
    """Raise unless the weights live on ``device``: the serve path never
    moves a model between devices on its own."""
    if params.device != device:
        raise ValueError(f"the model's weights are on {params.device}, the "
                         f"serve path runs on {device}")


class ServeScheduler:
    """Continuously-batched greedy decoding over a paged KV pool.

    ``lanes`` bounds concurrent requests, ``block_size``/``n_blocks`` the
    KV pool, ``max_len`` the longest supported ``prompt+max_new-1`` context
    (sets the block-table width).  ``device``: where it runs, default the
    card (raises when there is none); the weights must already be there.
    """

    def __init__(self, cfg: ModelConfig, params, *, lanes: int = 4,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 max_len: int = 512, device=None):
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        model = get_model(cfg)
        if not hasattr(model, "decode_step_paged"):
            raise ValueError(
                f"family {cfg.family!r} has no paged decode path; use "
                f"Engine.generate's contiguous loop")
        self.device = resolve_device(device)
        check_params_device(params, self.device)
        self.cfg, self.params, self.model = cfg, params, model
        self.lanes = int(lanes)
        self.max_blocks = -(-int(max_len) // int(block_size))
        if n_blocks is None:  # worst-case cover; pass less to page for real
            n_blocks = self.lanes * self.max_blocks + 1
        self.alloc = BlockAllocator(n_blocks, block_size)
        self.pool = model.init_paged_cache(cfg, n_blocks, block_size,
                                           device=self.device)
        self._tables = np.full((self.lanes, self.max_blocks), NULL_BLOCK,
                               np.int64)
        self._tok = np.zeros((self.lanes, 1), np.int64)
        # per-lane next KV position, maintained at admit / retire / step
        self._pos = np.zeros(self.lanes, np.int64)
        self._lane: List[Optional[_Lane]] = [None] * self.lanes
        self._waiting: "deque[_Waiting]" = deque()
        self.finished: Dict[int, np.ndarray] = {}
        self._next_rid = 0
        self.stats = {"admitted": 0, "admitted_inflight": 0, "retired": 0,
                      "steps": 0, "prefills": 0, "stalls": 0,
                      "peak_lanes": 0}

    # ------------------------------------------------------------- submit
    def submit(self, prompt, max_new: int, embeds=None) -> int:
        """Queue one request; returns its id (tokens land in
        :attr:`finished` once it retires).  ``prompt``: [T] or [1, T]."""
        prompt = torch.as_tensor(prompt, dtype=torch.int64, device=self.device)
        if prompt.ndim == 1:
            prompt = prompt[None]
        if prompt.ndim != 2 or prompt.shape[0] != 1:
            raise ValueError(
                f"one request per submit: prompt shape {tuple(prompt.shape)}")
        rid = self._next_rid
        self._next_rid += 1
        if max_new < 1:  # honor the [*, 0] contract without a prefill
            self.finished[rid] = np.zeros(0, np.int64)
            return rid
        tp = prompt.shape[1] + (embeds.shape[1] if embeds is not None else 0)
        need = tp + max_new - 1     # prefill + the max_new-1 decode writes
        if need > self.max_blocks * self.alloc.block_size:
            raise ValueError(
                f"request needs {need} KV slots > lane capacity "
                f"{self.max_blocks}x{self.alloc.block_size}; raise max_len")
        self._waiting.append(_Waiting(rid, prompt, int(max_new), embeds))
        return rid

    def pending(self) -> int:
        return len(self._waiting)

    def active(self) -> int:
        return sum(1 for ln in self._lane if ln is not None)

    # ---------------------------------------------------------- admission
    def _admit(self) -> None:
        """Fill free lanes from the waiting queue (FIFO) while the pool can
        cover each prefill."""
        while self._waiting:
            free = next((i for i, ln in enumerate(self._lane)
                         if ln is None), None)
            if free is None:
                return
            req = self._waiting[0]
            tp = req.prompt.shape[1] + (
                req.embeds.shape[1] if req.embeds is not None else 0)
            nb = self.alloc.blocks_for(tp)
            if nb > self.alloc.free_blocks():
                return          # a retirement will free blocks; stay FIFO
            self._waiting.popleft()
            blocks = self.alloc.alloc(nb)
            logits, cache = self.model.prefill(self.cfg, self.params,
                                               req.prompt, embeds=req.embeds)
            self.stats["prefills"] += 1
            # cache.k: [L, 1, T, H, D] -> this lane's blocks
            write_prefill(self.pool, cache.k[:, 0], cache.v[:, 0], blocks,
                          self.alloc.block_size)
            # analysis: allow(host-sync): the first token decides retirement
            tok = logits[0, -1].argmax().item()
            if self.active():
                self.stats["admitted_inflight"] += 1
            self.stats["admitted"] += 1
            lane = _Lane(rid=req.rid, blocks=blocks, pos=tp,
                         remaining=req.max_new - 1, out=[tok])
            self._lane[free] = lane
            self._tables[free, :] = NULL_BLOCK
            self._tables[free, :nb] = blocks
            self._tok[free, 0] = tok
            self._pos[free] = tp
            self.stats["peak_lanes"] = max(self.stats["peak_lanes"],
                                           self.active())
            if lane.remaining == 0:
                self._retire(free)

    def _retire(self, i: int) -> None:
        lane = self._lane[i]
        # analysis: allow(host-sync): token ids are host ints by now
        self.finished[lane.rid] = np.array(lane.out, np.int64)
        self.alloc.free(lane.blocks)
        self._lane[i] = None
        self._tables[i, :] = NULL_BLOCK
        self._tok[i, 0] = 0
        self._pos[i] = 0
        self.stats["retired"] += 1

    # ---------------------------------------------------------------- step
    def step(self) -> bool:
        """Admit, run one lane-batched decode step, retire.  Returns True
        while work remains (active lanes or waiting requests)."""
        self._admit()
        if not self.active():
            return bool(self._waiting)
        # lazily extend tables across block boundaries; stall on a dry pool
        runnable = np.zeros(self.lanes, bool)
        for i, lane in enumerate(self._lane):
            if lane is None:
                continue
            bi = lane.pos // self.alloc.block_size
            if bi >= len(lane.blocks):
                try:
                    (blk,) = self.alloc.alloc(1)
                    lane.blocks.append(blk)
                    self._tables[i, bi] = blk
                except OutOfBlocksError:
                    lane.stalled = True
                    self.stats["stalls"] += 1
                    continue
            lane.stalled = False
            runnable[i] = True
        if not runnable.any():
            raise OutOfBlocksError(
                f"every live lane is stalled: pool "
                f"{self.alloc.n_blocks}x{self.alloc.block_size} cannot "
                f"cover the admitted working set")
        # masked step arrays: idle/stalled lanes run against the null block
        tables = np.where(runnable[:, None], self._tables, NULL_BLOCK)
        pos = np.where(runnable, self._pos, 0)

        def dev(x):
            return torch.from_numpy(x).to(self.device)

        logits, self.pool = self.model.decode_step_paged(
            self.cfg, self.params, self.pool, dev(tables), dev(self._tok),
            dev(pos))
        # the one per-step device->host readback: sampled tokens must reach
        # the host to drive retire/admit decisions
        # analysis: allow(host-sync): per-step token readback, by design
        tok = logits[:, -1].argmax(dim=-1).tolist()
        self.stats["steps"] += 1
        for i in np.nonzero(runnable)[0]:
            lane = self._lane[i]
            lane.out.append(tok[i])
            self._tok[i, 0] = tok[i]
            lane.pos += 1
            self._pos[i] += 1
            lane.remaining -= 1
            if lane.remaining == 0:
                self._retire(i)
        return self.active() > 0 or bool(self._waiting)

    def run(self) -> Dict[int, np.ndarray]:
        """Drain everything queued/live; returns ``{rid: tokens}``."""
        while self.step():
            pass
        return dict(self.finished)
