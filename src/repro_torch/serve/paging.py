"""Paged KV-cache bookkeeping for the serve path.

Port of ``repro/serve/paging.py``.  The device-side storage is a
:class:`~repro_torch.models.layers.PagedKVCache`: one fixed pool of
``n_blocks`` blocks of ``block_size`` KV slots shared by every lane of the
serving batch.  This module owns everything host-side:

* :class:`BlockAllocator`: a free-list over the pool.  Blocks are handed
  out at admission (enough to cover the prefill), extended one block at a
  time as a lane decodes across a block boundary, and returned on
  retirement.  Block 0 is reserved as the *null block*: idle lanes park
  their (discarded) writes there.
* :func:`write_prefill`: scatters one lane's contiguous prefill cache into
  its allocated blocks (the one copy a request ever pays).
* :func:`gather_lane`: the inverse view, for tests and debugging.
"""
from __future__ import annotations

from collections import deque
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import PagedKVCache

#: block id every idle lane's table points at; never allocated.
NULL_BLOCK = 0


class OutOfBlocksError(RuntimeError):
    """The pool cannot cover a request and nothing can retire to free it."""


class BlockAllocator:
    """Host-side free-list allocator over a fixed block pool.

    ``stats`` tracks ``allocated`` / ``freed`` block counts, ``recycled``
    (allocations served by a block some earlier request used) and
    ``peak_used`` (high water mark of blocks in use).
    """

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError(
                f"n_blocks must be >= 2 (block 0 is the reserved null "
                f"block), got {n_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self._free: deque = deque(range(1, n_blocks))
        self._used: set = set()
        self._seen: set = set()
        self.stats = {"allocated": 0, "freed": 0, "recycled": 0,
                      "peak_used": 0}

    # ------------------------------------------------------------- queries
    def free_blocks(self) -> int:
        return len(self._free)

    def used_blocks(self) -> int:
        return len(self._used)

    def blocks_for(self, length: int) -> int:
        """Blocks covering ``length`` KV slots."""
        return -(-int(length) // self.block_size)

    # ------------------------------------------------------ alloc / free
    def alloc(self, n: int) -> List[int]:
        """Hand out ``n`` blocks; raises :class:`OutOfBlocksError` when the
        free list is short (the caller decides whether to stall or fail)."""
        if n > len(self._free):
            raise OutOfBlocksError(
                f"need {n} KV blocks, {len(self._free)} free "
                f"(pool {self.n_blocks} x {self.block_size})")
        out = [self._free.popleft() for _ in range(n)]
        self._used.update(out)
        self.stats["allocated"] += n
        self.stats["recycled"] += sum(1 for b in out if b in self._seen)
        self._seen.update(out)
        self.stats["peak_used"] = max(self.stats["peak_used"],
                                      len(self._used))
        return out

    def free(self, blocks: Sequence[int]) -> None:
        """Return a retired lane's blocks to the pool (FIFO recycle)."""
        for b in blocks:
            if b == NULL_BLOCK or b not in self._used:
                raise ValueError(f"block {b} is not currently allocated")
            self._used.discard(b)
            self._free.append(b)
        self.stats["freed"] += len(blocks)


# ---------------------------------------------------------------- copies --
def write_prefill(pool: PagedKVCache, k: torch.Tensor, v: torch.Tensor,
                  table: Sequence[int], block_size: int) -> PagedKVCache:
    """Scatter one lane's contiguous prefill KV ``[L, T, H, D]`` into its
    allocated blocks (``table``: the lane's first ``ceil(T/bs)`` block
    ids).  The tail of the last block is zero-padded: those positions sit
    beyond the lane's length and are masked to exact softmax zeros.  The
    port writes the pool in place (JAX returns an updated copy) and returns
    it."""
    t = k.shape[1]
    nb = len(table)
    if nb * block_size < t:
        raise ValueError(
            f"{nb} blocks x {block_size} cannot hold {t} prefill slots")

    def blocked(x):
        x = F.pad(x, (0, 0, 0, 0, 0, nb * block_size - t))
        return x.reshape(x.shape[0], nb, block_size, *x.shape[2:])

    idx = torch.tensor(list(table), dtype=torch.int64, device=pool.k.device)
    pool.k[:, idx] = blocked(k).to(pool.k.dtype)
    pool.v[:, idx] = blocked(v).to(pool.v.dtype)
    return pool


def gather_lane(pool: PagedKVCache, table: Sequence[int], length: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One lane's logical contiguous KV view ``[L, length, H, D]``."""
    idx = torch.tensor(list(table), dtype=torch.int64, device=pool.k.device)
    bs = pool.k.shape[2]

    def flat(x):
        x = x[:, idx]                       # [L, nb, bs, H, D]
        return x.reshape(x.shape[0], len(table) * bs,
                         *x.shape[3:])[:, :length]

    return flat(pool.k), flat(pool.v)
