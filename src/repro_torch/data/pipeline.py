"""Deterministic synthetic data pipeline (seeded, shardable, resumable).

Tokens are generated from a counter-based hash of (seed, step, position) so
any host can materialize exactly its shard of any step without coordination —
the property that makes restart/elastic-rescale trivial (no data-loader state
to checkpoint beyond the step counter).

Port of ``repro/data/pipeline.py``.  :func:`_hash_u64`,
:meth:`SyntheticTokens.batch_np` and :class:`SyntheticMatrices` are numpy,
copied from the reference (a test pins them equal); :meth:`SyntheticTokens.batch`
puts a batch, or one rank's rows ``lo:hi`` of it, on a torch device in
place of the reference's mesh form: each rank of the multi-rank trainer
materialises its own shard, as each host does there.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch


def _hash_u64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 — deterministic counter hash."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_np(self, step: int, *, lo: int = 0,
                 hi: Optional[int] = None) -> dict:
        """Rows ``lo:hi`` of the global batch for ``step`` (host shard)."""
        hi = self.global_batch if hi is None else hi
        rows = np.arange(lo, hi, dtype=np.uint64)[:, None]
        cols = np.arange(self.seq_len + 1, dtype=np.uint64)[None, :]
        ctr = (np.uint64(self.seed) * np.uint64(1 << 40)
               + np.uint64(step) * np.uint64(1 << 20)
               + rows * np.uint64(self.seq_len + 1) + cols)
        toks = (_hash_u64(ctr) % np.uint64(self.vocab)).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def batch(self, step: int, *, device="cuda", lo: int = 0,
              hi: Optional[int] = None) -> dict:
        """:meth:`batch_np` (rows ``lo:hi``) as int64 tensors on ``device``."""
        return {k: torch.as_tensor(v, dtype=torch.int64).to(device)
                for k, v in self.batch_np(step, lo=lo, hi=hi).items()}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_np(step)
            step += 1


@dataclasses.dataclass(frozen=True)
class SyntheticMatrices:
    """Private-matrix stream for the MPC examples (two 'sources')."""
    m: int
    seed: int = 0

    def pair(self, step: int) -> tuple:
        rng = np.random.default_rng((self.seed << 20) + step)
        a = rng.standard_normal((self.m, self.m)).astype(np.float32)
        b = rng.standard_normal((self.m, self.m)).astype(np.float32)
        return a, b
