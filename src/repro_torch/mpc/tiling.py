"""Shape adapter: rectangular & batched operands on the square coded grid.

The three-phase protocol evaluates one ``Y = AᵀB`` with square ``m×m``
operands, ``s|m`` and ``t|m`` (paper §IV).  Real workloads are not square:
the serving-time primitive the follow-up work targets is a rectangular
``[r,k]×[k,c]`` projection (an lm_head is ``[1,D]×[D,V]``), often with
leading batch dimensions.  This module maps such a product onto a grid of
coded ``m×m`` block-matmuls:

* **block size** — :func:`choose_block` picks the protocol side ``m``: a
  multiple of ``lcm(s,t)`` doubled until the tile count fits a budget, so
  tiny operands don't over-pad and large ones don't explode into thousands
  of protocol dispatches.  Doubling keeps the set of distinct plan keys
  (and therefore jit compiles) logarithmic in the workload sizes seen.
* **tiling** — :func:`tile_blocks` zero-pads each operand up to the grid
  and splits it into ``m×m`` tiles.  Padding is exact: field encoding maps
  0 ↦ 0, so padded rows/columns contribute nothing to any block product.
* **assembly** — ``Y[i,j] = Σ_l A[i,l] @ B[l,j] (mod p)``:
  :func:`assemble` folds the per-block protocol outputs back into the
  plaintext-shaped result (the inner sum stays in the field, one decode at
  the end — fixed-point scale is unchanged by the sum).

Everything here is geometry; the session layer (:mod:`repro_torch.mpc.api`)
owns field encode/decode and hands the blocks to a pluggable backend.

Port of ``repro/mpc/tiling.py``: the block search is the same code, and
:func:`tile_blocks` / :func:`assemble` act on torch tensors on any device.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Iterator, Tuple

import torch

# default cap on protocol dispatches per matmul: below it, smaller tiles
# only add host-side dispatch; above it, padding waste dominates
DEFAULT_TILE_BUDGET = 64


class TileBudgetWarning(RuntimeWarning):
    """The dispatch budget is infeasible even at the coarsest block side.

    The adapter clamps to the fewest-dispatches side instead of failing —
    the documented over-budget fallback — and warns so misconfigured
    budgets (tiny budget × large batch) surface instead of silently
    over-dispatching."""


def n_tiles(m: int, r: int, k: int, c: int) -> int:
    """Block-product count for an ``[r,k]×[k,c]`` matmul at tile side m."""
    return (-(-r // m)) * (-(-k // m)) * (-(-c // m))


def padded_volume(m: int, r: int, k: int, c: int) -> int:
    """Coded work proxy: the product of grid-padded dimensions."""
    def up(d):
        return (-(-d // m)) * m

    return up(r) * up(k) * up(c)


def choose_block(s: int, t: int, r: int, k: int, c: int,
                 *, budget: int = DEFAULT_TILE_BUDGET) -> int:
    """Tile side ``lcm(s,t)·2^j``: fit the dispatch budget, then coarsen.

    Doubles from ``lcm(s,t)`` until the tile count fits ``budget`` (host
    dispatch is the scarce resource), then keeps doubling while the padded
    volume does not grow — so divisible shapes collapse to the fewest
    dispatches (a square ``m×m`` call becomes ONE protocol block) while
    ragged shapes keep their padding small.  Never grows past the largest
    operand dimension (``lcm(s,t)`` itself may exceed it — the protocol
    can't partition anything smaller, so one padded block is returned),
    and never returns a side the protocol can't partition.

    Over-budget fallback (explicit, not silent): when even the coarsest
    side the search reaches still exceeds ``budget``, the coarsest side is
    returned as a documented clamp and a :class:`TileBudgetWarning` is
    emitted.
    """
    if budget < 1:
        raise ValueError(f"tile budget must be >= 1, got {budget}")
    lcm = math.lcm(s, t)
    m = lcm
    big = max(r, k, c)
    while m < big and n_tiles(m, r, k, c) > budget:
        m *= 2
    while m < big and (padded_volume(2 * m, r, k, c)
                       <= padded_volume(m, r, k, c)):
        m *= 2
    _check_budget(m, n_tiles(m, r, k, c), budget, (r, k, c))
    return m


def _check_budget(m: int, blocks: int, budget: int, shape,
                  batch: int = 1) -> None:
    if blocks > budget:
        what = (f"{blocks} protocol dispatches" if batch == 1 else
                f"{blocks} protocol dispatches (batch {batch} × "
                f"{blocks // batch} tiles)")
        warnings.warn(
            f"tile budget {budget} infeasible for shape {shape}: clamping "
            f"to block side {m} with {what}",
            TileBudgetWarning, stacklevel=3)


def block_candidates(s: int, t: int, r: int, k: int, c: int, *,
                     batch: int = 1,
                     budget: int = DEFAULT_TILE_BUDGET
                     ) -> Iterator[Tuple[int, int, bool]]:
    """Yield every candidate tile side with its workload dispatch count.

    Sides are ``lcm(s,t)·2^j`` up to (and including) the first side
    covering the largest operand dimension — the same logarithmic family
    :func:`choose_block` walks.  Yields ``(m, blocks, over_budget)`` where
    ``blocks = batch × n_tiles`` is the protocol dispatch count for the
    whole (possibly batched) workload.  The cost-model searches
    (:func:`choose_block_cost`, :mod:`repro.mpc.autotune`) rank these
    candidates instead of hard-coding the fixed-``(s,t)`` doubling rule.
    """
    if budget < 1:
        raise ValueError(f"tile budget must be >= 1, got {budget}")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    m = math.lcm(s, t)
    big = max(r, k, c)
    while True:
        blocks = batch * n_tiles(m, r, k, c)
        yield m, blocks, blocks > budget
        if m >= big:
            return
        m *= 2


def best_block(s: int, t: int, z: int, n_workers: int,
               r: int, k: int, c: int, *, cost, batch: int = 1,
               budget: int = DEFAULT_TILE_BUDGET,
               pool=None, placement=None) -> Tuple[int, int, bool, float]:
    """The best-ranked ``(m, blocks, over_budget, score)`` of
    :func:`block_candidates` under one cost model.

    The single ranking rule shared by :func:`choose_block_cost` and the
    autotuner's joint ``(s, t, m)`` search (:mod:`repro.mpc.autotune`) —
    budget-respecting candidates first, then (for over-budget ones) the
    fewest dispatches, then the lowest weighted Cor. 8–10 score
    ``cost.total(m, s, t, z, N, blocks)``, then the coarser side.  One
    helper so a tuned spec's baked-in ``m`` and a ``cost=`` session's
    block choice can never drift apart.

    ``pool``/``placement`` (a :class:`repro.mpc.workers.WorkerPool` + the
    device assignment) switch the score to the per-worker-weighted form;
    they are only forwarded when given, so duck-typed cost objects that
    predate the pool keyword keep working.
    """
    pw = {} if pool is None else {"pool": pool, "placement": placement}
    best = None
    for m, blocks, over in block_candidates(s, t, r, k, c, batch=batch,
                                            budget=budget):
        sc = cost.total(m, s, t, z, n_workers, blocks, **pw)
        key = (over, blocks if over else 0, sc, -m)
        if best is None or key < best[0]:
            best = (key, (m, blocks, over, sc))
    return best[1]


def choose_block_cost(s: int, t: int, z: int, n_workers: int,
                      r: int, k: int, c: int, *, cost, batch: int = 1,
                      budget: int = DEFAULT_TILE_BUDGET,
                      pool=None, placement=None) -> int:
    """Cost-model-aware :func:`choose_block` (DESIGN.md §7).

    Picks the :func:`best_block` side; when no side fits the budget the
    fewest-dispatch side wins and :class:`TileBudgetWarning` is emitted
    (same documented clamp as :func:`choose_block`).

    Budget semantics are *stricter* here than on the default path:
    ``budget`` caps the whole workload's dispatch count (``batch ×
    n_tiles``), whereas :func:`choose_block` — which never sees the batch
    — caps the per-piece tile count only.  A batched call that fits
    per-piece but not in total therefore coarsens (and, at the coarsest
    side, warns) under a cost model where the default path would silently
    dispatch ``batch × budget`` blocks.

    ``cost`` is any object with the :class:`repro.mpc.autotune.CostModel`
    interface (``total(m, s, t, z, n, blocks)``); taking it as a duck-typed
    argument keeps this module free of an autotune import cycle.
    """
    m, blocks, _, _ = best_block(s, t, z, n_workers, r, k, c, cost=cost,
                                 batch=batch, budget=budget, pool=pool,
                                 placement=placement)
    _check_budget(m, blocks, budget, (r, k, c), batch)
    return m


@dataclasses.dataclass(frozen=True)
class TileMap:
    """Grid geometry for one ``[r,k]×[k,c]`` product at tile side ``m``."""

    m: int
    r: int
    k: int
    c: int

    @property
    def gr(self) -> int:
        return -(-self.r // self.m)

    @property
    def gk(self) -> int:
        return -(-self.k // self.m)

    @property
    def gc(self) -> int:
        return -(-self.c // self.m)

    @property
    def n_blocks(self) -> int:
        return self.gr * self.gk * self.gc

    def block_index(self, i: int, j: int, l: int) -> int:
        """Position of block product ``A[i,l]·B[l,j]`` in the op list."""
        return (i * self.gc + j) * self.gk + l


def tile_blocks(x, m: int):
    """``[d0, d1] -> [g0, g1, m, m]``: zero-pad to the grid and split."""
    d0, d1 = x.shape
    g0, g1 = -(-d0 // m), -(-d1 // m)
    xp = torch.nn.functional.pad(x, (0, g1 * m - d1, 0, g0 * m - d0))
    return xp.reshape(g0, m, g1, m).permute(0, 2, 1, 3)


def assemble(tm: TileMap, outs, p: int):
    """Fold the ordered block outputs back into ``[r, c]`` (mod p).

    ``outs``: one ``[m, m]`` field-domain array per block, ordered by
    :meth:`TileMap.block_index`.  The inner ``Σ_l`` folds mod p (adding
    block products never changes the fixed-point scale).
    """
    stack = torch.stack(list(outs)).reshape(tm.gr, tm.gc, tm.gk, tm.m, tm.m)
    y = stack[:, :, 0]
    for l in range(1, tm.gk):
        y = torch.remainder(y + stack[:, :, l], p)
    full = y.permute(0, 2, 1, 3).reshape(tm.gr * tm.m, tm.gc * tm.m)
    return full[: tm.r, : tm.c]
