"""The one input generator: every number a run feeds the program comes from
``--seed`` through here, and the same seed gives the same inputs.

Traffic files (``portbench/traffic/<name>.json``) hold only parameters;
these functions read them.  Draws happen on the run's device with a
``torch.Generator`` of their own, seeded from ``(seed, purpose, index)``,
so any input can be drawn again alone (the reference does so after the
window) and no two draws share a stream.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

_MASK64 = (1 << 64) - 1
PURPOSES = {"hidden": 1, "head": 2, "weights": 3, "sample": 4, "tokens": 5}


def subseed(seed: int, purpose: str, index: int = 0) -> int:
    """A 63-bit seed for one draw: splitmix64 over the run's seed, the
    draw's purpose and its index (any seed up to 2^64 - 1)."""
    x = int(seed) & _MASK64
    for part in (PURPOSES[purpose], int(index)):
        x = (x + 0x9E3779B97F4A7C15 + part) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x >> 1


def generator(seed: int, purpose: str, index: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, purpose, index))
    return g


def normal(shape, seed: int, purpose: str, index: int, device,
           std: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """``N(0, std^2)`` drawn in fp32 on ``device``, then cast to ``dtype``."""
    g = generator(seed, purpose, index, device)
    x = torch.randn(tuple(shape), generator=g, device=device,
                    dtype=torch.float32)
    if std != 1.0:
        x.mul_(std)
    return x.to(dtype)


def hidden_states(seed: int, index: int, rows: int, width: int, device,
                  *, eps: float = 1e-5) -> torch.Tensor:
    """One call's final hidden states ``[rows, width]`` in fp32, as a model
    hands them to its head: normal draws through an RMS norm with unit
    scale, so every row has unit root mean square."""
    x = normal((rows, width), seed, "hidden", index, device)
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)


def sample(seed: int, count: int, span: int) -> list:
    """``count`` distinct indices below ``span`` drawn from the seed, index
    0 always among them (the first call after warm-up)."""
    rng = np.random.default_rng(subseed(seed, "sample"))
    rest = rng.choice(np.arange(1, span), size=min(count - 1, span - 1),
                      replace=False)
    return sorted({0, *(int(i) for i in rest)})


# ---------------------------------------------------------------- tokens --
def _hash_u64(x: np.ndarray) -> np.ndarray:
    """SplitMix64, the counter hash of the program's ``SyntheticTokens``
    (a frozen copy)."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    """Token batches from a counter hash of ``(seed, step, row, position)``:
    a frozen copy of ``repro_torch.data.pipeline.SyntheticTokens``, with the
    seed reduced to 63 bits first so that any seed a run is given fits
    the counter."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_np(self, step: int, *, lo: int = 0,
                 hi: Optional[int] = None) -> dict:
        hi = self.global_batch if hi is None else hi
        rows = np.arange(lo, hi, dtype=np.uint64)[:, None]
        cols = np.arange(self.seq_len + 1, dtype=np.uint64)[None, :]
        with np.errstate(over="ignore"):
            ctr = (np.uint64(subseed(self.seed, "tokens"))
                   * np.uint64(1 << 40)
                   + np.uint64(step) * np.uint64(1 << 20)
                   + rows * np.uint64(self.seq_len + 1) + cols)
            toks = (_hash_u64(ctr) % np.uint64(self.vocab)).astype(np.int64)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def batch(self, step: int, device) -> dict:
        return {k: torch.from_numpy(v).to(device)
                for k, v in self.batch_np(step).items()}
