"""Elastic worker-pool management: spares, failures, re-planning.

Port of ``repro/mpc/elastic.py``: host-side NumPy over the port's planner,
the same code as the reference's.

The coded redundancy gives two distinct tolerance windows:

* **Phase-3 window** (free): once workers hold ``I(α_n)``, any
  ``N − (t²+z)`` of them may vanish; the master decodes from the survivor
  α-set (``AGECMPCProtocol.decode(survivors=...)``) with rows served out of
  the plan's survivor-table LRU.
* **Phase-2 window** (needs spares): eq. (9) interpolates ``H(x)`` from all
  ``N = |P(H)|`` points, so losing a worker *before* the exchange needs a
  spare.  :class:`ElasticPool` provisions ``N + spares`` evaluation points
  up front; on failure it re-derives the reconstruction weights for a
  surviving N-subset — no data re-sharing, the sources' shares at spare α's
  were distributed in phase 1.

Everything data-dependent the pool used to compute per call is now a plan
cache lookup (DESIGN.md §5): the pool α's come from
:meth:`repro.mpc.planner.ProtocolPlan.pool_alphas` — the plan's
invertibility-searched α-set extended with validated spares, NOT a private
``np.arange`` that silently diverges when the plan's α's were re-seeded —
and :meth:`reconstruction_weights` resolves through the plan's survivor-
solve LRU, so repeated failure patterns cost one Gauss–Jordan total.

If the pool drops below ``N``, we *re-plan*: re-solve ``min_λ Γ(λ)`` for a
coarser partitioning (smaller t) whose worker requirement fits the surviving
pool — trading per-worker load for feasibility (the s/t trade-off of
Fig. 2/3).  Candidate sizing uses the planner's memoized code resolution,
and the winning protocol's tables come from the shared :func:`get_plan`
cache — re-planning to an already-seen parameterization is table-lookup
cheap.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .api import MPCSpec
from .errors import QuorumError
from .field import DEFAULT_FIELD, Field
from .planner import _resolve_code
from .protocol import AGECMPCProtocol
from .workers import WorkerPool


@dataclasses.dataclass
class ElasticPool:
    """A CMPC plan over ``N + spares`` provisioned workers.

    With a heterogeneous :class:`~repro.mpc.workers.WorkerPool` roster
    (DESIGN.md §8): the first N pool slots are the spec's placement
    (devices chosen/ordered by the tuner), spare slots are drawn from the
    *unplaced* remainder preferring the highest-capacity devices, and
    ``device_map`` records the roster device behind every provisioned
    slot — failure reports arrive in device ids (:meth:`fail_devices`)
    and re-tuning sees the surviving *capacity vector*, not just the
    surviving count (:meth:`surviving_pool`).
    """

    s: int
    t: int
    z: int
    m: int
    spares: int = 2
    scheme: str = "age"
    lam: Optional[int] = None
    field: Field = DEFAULT_FIELD
    pool: Optional[WorkerPool] = None
    placement: Optional[Tuple[int, ...]] = None
    adversaries: int = 0

    @classmethod
    def from_spec(cls, spec: MPCSpec, *, spares: int = 2,
                  m: Optional[int] = None) -> "ElasticPool":
        """A pool for one unified spec (block side from ``m`` or ``spec.m``)."""
        return cls(s=spec.s, t=spec.t, z=spec.z, m=spec._block(m),
                   spares=spares, scheme=spec.scheme, lam=spec.lam,
                   field=spec.field, pool=spec.pool,
                   placement=spec.effective_placement,
                   adversaries=spec.adversaries)

    @property
    def spec(self) -> MPCSpec:
        return self.proto.spec

    def __post_init__(self):
        self.proto = AGECMPCProtocol.from_spec(MPCSpec(
            s=self.s, t=self.t, z=self.z, lam=self.lam,
            scheme=self.scheme, field=self.field, m=self.m,
            pool=self.pool, placement=self.placement,
            adversaries=self.adversaries))
        n = self.proto.n_workers
        if self.pool is None:
            self.device_map: Optional[Tuple[int, ...]] = None
            self.pool_size = n + self.spares
        else:
            # spare inventory: the unplaced remainder of the roster,
            # highest-capacity first (the spare-preference contract) —
            # clamped to what the roster actually has left
            self.placement = self.proto.placement
            spare_devs = self.pool.spares_for(self.placement)[: self.spares]
            self.device_map = tuple(self.placement) + tuple(spare_devs)
            self.pool_size = n + len(spare_devs)
        self.alive = np.ones(self.pool_size, dtype=bool)
        # the plan's α-set (invertibility-searched, possibly re-seeded)
        # extended with validated spare points — one evaluation grid for
        # distributed shares AND spares (regression: a private arange here
        # solved weights at α's where no shares were ever distributed)
        self._alphas = self.proto.plan.pool_alphas(self.pool_size)

    # ------------------------------------------------------------- failures
    def fail(self, workers) -> None:
        # analysis: allow(host-sync): worker ids are host data
        self.alive[np.asarray(workers)] = False

    def fail_devices(self, devices) -> None:
        """Report attrition in roster *device* ids (pool-backed pools).

        Devices outside the provisioned slots (never placed, not drawn as
        spares) are dropped — they held no shares.  Without a roster this
        falls back to slot semantics (ids already are slots)."""
        if self.device_map is None:
            # analysis: allow(host-sync): worker ids are host data
            ids = [int(d) for d in np.atleast_1d(np.asarray(devices))
                   if int(d) < self.pool_size]
            if ids:
                self.fail(ids)
            return
        inv = {d: i for i, d in enumerate(self.device_map)}
        # analysis: allow(host-sync): worker ids are host data
        slots = [inv[int(d)] for d in np.atleast_1d(np.asarray(devices))
                 if int(d) in inv]
        if slots:
            self.fail(slots)

    def surviving_devices(self) -> Optional[Tuple[int, ...]]:
        """Original-roster device ids behind the still-alive provisioned
        slots (``None`` without a roster).  The surviving capacity vector
        for the fixed-``m`` re-tune — ids stay roster-indexed, so the
        re-tuned spec's failure routing never re-bases."""
        if self.pool is None:
            return None
        return tuple(self.device_map[i] for i in np.nonzero(self.alive)[0])

    def healthy_devices(self) -> Optional[Tuple[int, ...]]:
        """Every roster device not known dead: the alive provisioned slots
        PLUS the never-provisioned remainder (``None`` without a roster).
        Queued work that has not been tiled/distributed yet (the drain
        path) is free to use all of these, not just provisioned slots."""
        if self.pool is None:
            return None
        dead = {self.device_map[i] for i in np.nonzero(~self.alive)[0]}
        return tuple(d for d in range(len(self.pool)) if d not in dead)

    def active_subset(self) -> np.ndarray:
        """First N alive workers (phase-2 quorum), or raise if infeasible."""
        idx = np.nonzero(self.alive)[0]
        n = self.proto.n_workers
        if len(idx) < n:
            raise QuorumError(
                f"pool has {len(idx)} alive < N={n}; re-plan required",
                quorum=n, alive=len(idx),
                slots=np.nonzero(~self.alive)[0])
        return idx[:n]

    def reconstruction_weights(self) -> Tuple[np.ndarray, np.ndarray]:
        """(subset, r-coefficient rows) for the current survivor quorum.

        A plan-cache lookup: the generalized-Vandermonde solve over ``P(H)``
        at the quorum α's runs once per distinct failure pattern and is
        LRU-cached on the plan (``plan.quorum_weights``).
        """
        idx = self.active_subset()
        w = self.proto.plan.quorum_weights(tuple(idx), self.pool_size)
        return idx, w

    def phase3_tolerance(self) -> int:
        """Failures absorbable after the exchange with zero recomputation.

        With an adversary budget ``a``, ``2a`` of the redundant shares are
        reserved for error location/exclusion (the verified quorum is
        ``t²+z+2a``), so crash tolerance shrinks by that reservation."""
        return (self.proto.n_workers - self.proto.recovery_threshold
                - 2 * self.adversaries)

    # -------------------------------------------------------------- re-tune
    def retune(self, cost=None) -> Optional[AGECMPCProtocol]:
        """Pool shrank below N: re-solve the paper's optimization layer for
        the best spec decodable with the *surviving* workers (DESIGN.md §7).

        Unlike the greedy :meth:`replan` (max ``st²`` under feasibility),
        this ranks every partition dividing the in-flight block side ``m``
        — including the gap λ for AGE — by the weighted Cor. 8–10
        objective (``cost``: a :class:`repro.mpc.autotune.CostModel`,
        default weights when ``None``).  The engine escalation order is
        re-tune first, greedy replan as fallback.  Returns the new
        protocol, or ``None`` when nothing fits the survivors.
        """
        from .autotune import retune_spec

        if self.pool is None:
            spec = retune_spec(int(self.alive.sum()), self.z, m=self.m,
                               field=self.field, cost=cost,
                               schemes=(self.scheme,),
                               adversaries=self.adversaries)
        else:
            # re-tune against the surviving CAPACITY VECTOR, not just the
            # surviving count: the candidate search re-places every N on
            # the still-alive devices of the ORIGINAL roster (ids stay
            # stable — DESIGN.md §8)
            spec = retune_spec(z=self.z, m=self.m, pool=self.pool,
                               within=self.surviving_devices(),
                               field=self.field, cost=cost,
                               schemes=(self.scheme,),
                               adversaries=self.adversaries)
        return None if spec is None else AGECMPCProtocol.from_spec(spec)

    # -------------------------------------------------------------- re-plan
    def replan(self) -> Optional[AGECMPCProtocol]:
        """Pool shrank below N: find the largest-throughput (s', t') whose
        ``N(s', t', z)`` fits the surviving pool.  Returns the new protocol
        (or None if even t=1 BGW-like splitting doesn't fit).

        Candidates are sized through the planner's memoized code resolution
        — no throwaway protocol instances — and the winner's tables resolve
        through the shared ``get_plan`` cache, so re-planning to a
        parameterization any pool has seen before builds nothing.
        """
        alive = int(self.alive.sum())
        best: Optional[Tuple[int, int, int]] = None
        for t in range(self.t, 0, -1):
            for s in range(self.s, 0, -1):
                if s == 1 and t == 1:
                    continue
                if self.m % s or self.m % t:
                    continue
                code = _resolve_code(self.scheme, s, t, self.z, self.lam)
                if code.n_workers > alive:
                    continue
                # verified quorum: a liar budget reserves 2a extra shares
                if code.n_workers < t * t + self.z + 2 * self.adversaries:
                    continue
                # prefer max st² (least per-worker compute: m³/(st²))
                if best is None or s * t * t > best[0]:
                    best = (s * t * t, s, t)
        if best is None:
            return None
        _, s, t = best
        return AGECMPCProtocol.from_spec(MPCSpec(
            s=s, t=t, z=self.z, lam=self.lam, scheme=self.scheme,
            field=self.field, m=self.m, adversaries=self.adversaries))
