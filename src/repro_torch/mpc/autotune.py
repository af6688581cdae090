"""Autotuned spec selection from the paper's cost model (DESIGN.md §7).

Port of ``repro/mpc/autotune.py``: NumPy and dataclasses, the same code
over the port's planner, tiling and :mod:`repro_torch.mpc.workers` (a
verbatim copy), so ranked candidates and placements equal the reference's.
:meth:`CostModel.from_bench` reads a bench trajectory as data; the port
quotes no time from the JAX era's ``BENCH_PROTOCOL.json``.

The paper's central claim is that AGE codes *optimize* polynomial degrees
for MPC: Theorem 3 gives the worker count of every gap λ, and Corollaries
8–10 give the per-worker computation / storage / communication overheads
any ``(s, t)`` partition pays at its worker count.  The repo has carried
both layers since the seed (:mod:`repro.core.worker_counts`,
:mod:`repro.core.overheads`) — but the runtime :class:`~repro.mpc.api
.MPCSpec` still made the *caller* hand-pick ``(scheme, s, t, λ)``.  This
module is the bridge:

* :class:`CostModel` — the weighted Cor. 8–10 objective.  Weights are per
  *scalar* (the paper's Fig. 3 unit): ``computation`` multiplies ξ (scalar
  mults per worker, eq. (15)), ``storage`` multiplies σ (scalars stored
  per worker, eq. (16)), ``communication`` multiplies ζ (scalars
  exchanged, eq. (17)); ``dispatch`` is a per-protocol-block host cost for
  tiled workloads (the serving-side term the paper does not model).
* :func:`tune` — given a worker budget ``N``, privacy bound ``z`` and a
  workload shape ``[r,k]×[k,c]`` (+ batch), enumerate the generalized code
  family — AGE over every feasible ``(s, t, λ)``, Entangled (λ=0) and
  PolyDot — keep candidates whose required worker count fits the budget,
  co-optimize the coded tile side ``m`` *jointly* with ``(s, t)`` (the
  fixed-``(s,t)`` search of :func:`repro.mpc.tiling.choose_block` becomes
  :func:`repro.mpc.tiling.choose_block_cost` inside the candidate loop),
  and rank by the weighted total overhead.  Returns a :class:`TuneResult`
  whose ``spec`` is a frozen, validated :class:`~repro.mpc.api.MPCSpec`
  with the winning block side baked in.
* :func:`retune_spec` — the attrition-time variant: the block side ``m``
  is already fixed (shares were tiled for it), the worker budget is the
  *surviving* pool, and the search runs over the divisors of ``m``.  The
  elastic layer (:meth:`repro.mpc.elastic.ElasticPool.retune`) and the
  batched engine's escalation path resolve through it before falling back
  to the legacy greedy ``replan``.

Heterogeneous pools (DESIGN.md §8): every entry point takes ``pool=``
(a :class:`~repro.mpc.workers.WorkerPool`); the objective then scales
each Cor. 8–10 term by the placed bottleneck device, candidates carry an
evaluation-point placement, and :meth:`CostModel.from_bench` calibrates
the µs/scalar weights from the measured ``BENCH_PROTOCOL.json``
trajectory.  A homogeneous pool is score- and ranking-identical to the
bare ``int N`` budget.

Candidate worker counts come from the memoized degree-set enumeration
(:func:`repro.mpc.planner._resolve_code` — always correct by
construction); ``tests/test_autotune.py`` proves the tuner agrees with
the closed forms of :mod:`repro.core.worker_counts` on the Theorem-3
validation grid.  Every overhead term of eq. (15)–(17) is strictly
increasing in ``N`` at fixed ``(m, s, t, z)``, so for one partition the
tuner always lands on ``min_λ Γ(λ)`` — eq. (13) — whatever the weights;
across partitions the weights arbitrate the paper's s/t trade-off
(Fig. 2/3).
"""
from __future__ import annotations

import dataclasses
import json
import re
import warnings
from typing import Mapping, Optional, Sequence, Tuple

from ..core.overheads import Overheads, overheads
from .field import DEFAULT_FIELD, Field
from .planner import _resolve_code
from .tiling import DEFAULT_TILE_BUDGET, _check_budget, best_block
from .workers import WorkerPool

#: partition sides searched per axis when (s, t) are free; worker counts
#: grow ~ st² so the budget prunes far earlier in practice
MAX_PARTITION = 8

_SCHEME_RANK = {"age": 0, "entangled": 1, "polydot": 2}


class CalibrationWarning(RuntimeWarning):
    """A cost-model calibration fell back to the paper's equal weights.

    Emitted by :meth:`CostModel.from_bench` when the bench trajectory is
    missing/unreadable, has too few usable samples, or fits degenerate
    weights — the returned model is still valid (pure Fig. 3 objective),
    but its ranking is *unmeasured* for the current backend, which is
    exactly the regression the fleet simulator's divergence gate exists
    to catch (DESIGN.md §11).  Filter with ``warnings.simplefilter`` in
    contexts where the fallback is expected (fresh checkouts, unit
    tests).
    """


class UnknownEntryWarning(RuntimeWarning):
    """A bench entry contributed no usable calibration sample.

    Emitted (once per entry name per process) by
    :meth:`CostModel.from_bench` for trajectory entries whose ``derived``
    column carries neither the Cor. 8–10 ``xi=…;sigma=…;zeta=…`` counts
    nor a transport ``wire_zeta=…;wire_us=…`` pair — previously these
    were skipped silently, which hid typos in new bench families from
    the calibration.  Distinct from :class:`CalibrationWarning`: the fit
    itself still proceeds on the usable samples.
    """


#: entry names already reported through UnknownEntryWarning — module
#: scope, so repeated calibrations don't re-warn about the same
#: intentionally-uncalibrated bench families (fleet_replay, …)
_WARNED_UNKNOWN: set = set()


# ============================================================== cost model
@dataclasses.dataclass(frozen=True)
class CostModel:
    """Weights for the Cor. 8–10 objective (per scalar; Fig. 3 units).

    ``computation``  — weight on ξ, scalar multiplications per worker
                       (eq. (15): ``m³/(st²) + m² + N(t²+z−1)m²/t²``);
    ``storage``      — weight on σ, scalars stored per worker
                       (eq. (16): ``(2N+z+1)m²/t² + 2m²/(st) + t²``);
    ``communication``— weight on ζ, scalars exchanged among workers
                       (eq. (17): ``N(N−1)m²/t²``);
    ``dispatch``     — host-side cost per protocol block, the serving-side
                       term tiled workloads add on top of the paper's
                       per-block model (0 ⇒ pure paper objective).

    All weights must be ≥ 0.  Every per-block term is strictly increasing
    in ``N`` at fixed ``(m, s, t, z)``, so the ranking degenerates to
    fewest-workers when all weights are equal *within* one partition —
    the weights arbitrate *across* partitions.
    """

    computation: float = 1.0
    storage: float = 1.0
    communication: float = 1.0
    dispatch: float = 0.0
    #: measured per-`WorkerClass` (ξ, σ, ζ) rate multipliers, as a sorted
    #: ``((name, (mc, ms, ml)), …)`` tuple so the model stays hashable;
    #: empty ⇒ hand-set pool rates are trusted as-is (DESIGN.md §11)
    class_multipliers: Tuple[Tuple[str, Tuple[float, float, float]], ...] = ()

    def __post_init__(self):
        for name in ("computation", "storage", "communication", "dispatch"):
            v = getattr(self, name)
            if not (isinstance(v, (int, float)) and v >= 0):
                raise ValueError(f"{name} weight must be >= 0, got {v!r}")
        for cls_name, mult in self.class_multipliers:
            if len(mult) != 3 or any(not (isinstance(f, (int, float))
                                          and f > 0) for f in mult):
                raise ValueError(
                    f"class multiplier for {cls_name!r} must be three "
                    f"positive factors, got {mult!r}")

    def block(self, m: int, s: int, t: int, z: int, n: int, *,
              pool: Optional[WorkerPool] = None,
              placement: Optional[Sequence[int]] = None) -> float:
        """Weighted per-block overhead of one coded ``m×m`` product.

        With a :class:`~repro.mpc.workers.WorkerPool`, each Cor. 8–10 term
        is scaled by the worst per-resource slowdown over the *placed*
        devices (``pool.bottleneck``): the protocol is synchronous, so the
        slowest assigned worker bounds every phase.  Unit (homogeneous)
        classes scale by exactly 1.0, so homogeneous pools score — and
        therefore rank — bit-identically to the legacy ``int N`` path.
        ``placement`` defaults to :meth:`WorkerPool.place` under these
        weights.
        """
        ov = overheads(m, s, t, z, n)
        cmax = smax = lmax = 1.0
        if pool is not None:
            pool = self.recalibrated_pool(pool)
            if placement is None:
                placement = pool.place(n, self)
            cmax, smax, lmax = pool.bottleneck(placement)
        return (self.computation * ov.computation * cmax
                + self.storage * ov.storage * smax
                + self.communication * ov.communication * lmax)

    def total(self, m: int, s: int, t: int, z: int, n: int,
              blocks: int, *, pool: Optional[WorkerPool] = None,
              placement: Optional[Sequence[int]] = None) -> float:
        """Workload objective: ``blocks`` coded products + dispatch cost."""
        return blocks * (self.block(m, s, t, z, n, pool=pool,
                                    placement=placement) + self.dispatch)

    def with_dispatch_scale(self, scale: float) -> "CostModel":
        """These weights with the per-block dispatch term scaled.

        Backends whose per-block launch cost is a multiple of the host
        baseline report a scale through ``MPCBackend.dispatch_scale`` —
        the sharded runner packs N logical workers onto a D-device mesh
        axis in ``ceil(N/D)`` serialized waves, so its dispatch weight is
        that wave count (DESIGN.md §8).
        """
        if scale == 1.0:
            return self
        return dataclasses.replace(self, dispatch=self.dispatch * scale)

    def with_class_multipliers(
            self, multipliers: Mapping[str, Sequence[float]]) -> "CostModel":
        """These weights carrying measured per-class (ξ, σ, ζ) rate
        multipliers (DESIGN.md §11).

        ``multipliers`` maps a :class:`~repro.mpc.workers.WorkerClass`
        name to the three per-resource factors a calibration fit
        recovered (:func:`repro.sim.calibrate.fit_class_multipliers`).
        They are stored sorted-by-name so equal calibrations hash and
        compare equal, and applied wherever the model touches a pool —
        :meth:`block` scoring, :func:`search`/:func:`retune_spec`
        placement, :func:`predicted_makespan` — via
        :meth:`recalibrated_pool`.
        """
        packed = []
        for name, f in multipliers.items():
            factors = tuple(float(x) for x in f)
            if len(factors) != 3:
                raise ValueError(
                    f"class {name!r} needs exactly 3 (xi, sigma, zeta) "
                    f"factors, got {len(factors)}")
            packed.append((str(name), factors))
        return dataclasses.replace(self,
                                   class_multipliers=tuple(sorted(packed)))

    def recalibrated_pool(self, pool):
        """``pool`` with this model's class multipliers applied — the
        unchanged pool when none are set (the hand-set-rates path stays
        bit-identical)."""
        if pool is None or not self.class_multipliers:
            return pool
        return pool.recalibrated(dict(self.class_multipliers))

    # ------------------------------------------------------------ calibration
    @classmethod
    def from_bench(cls, path: str = "BENCH_PROTOCOL.json", *,
                   dispatch: float = 0.0,
                   fallback: Optional["CostModel"] = None) -> "CostModel":
        """Weights calibrated from the measured ``BENCH_PROTOCOL.json``
        trajectory (ROADMAP "Measured cost models").

        Every ``cmpc_*`` pair in the trajectory carries its wall time
        (``fused_us``) and the Cor. 8–10 scalar counts in the derived
        column (``xi=…;sigma=…;zeta=…``); fitting ``us ≈ w_ξ·ξ + w_σ·σ +
        w_ζ·ζ`` over all runs yields per-phase **µs-per-scalar** weights
        for the backend that produced the file, so predicted ordering
        tracks wall time on that device class instead of raw scalar
        counts.  The fit is a deterministic ridge-regularized least
        squares with an active-set clamp at 0 (collinear trajectories —
        e.g. two schemes sharing one N — stay solvable; the weights are
        then ordering-grade, not physical attribution).

        ``transport_*`` pairs additionally carry measured per-phase wire
        legs as ``wire_zeta=…;wire_us=…`` segments (one per recorded
        exchange sample); each becomes a pure-communication row, so ζ is
        anchored to real wire time.  Entries contributing *no* usable
        sample raise an :class:`UnknownEntryWarning` naming them — once
        per entry name per process, so a typo'd bench family cannot
        silently drop out of the calibration.

        Falls back to the paper's equal weights when the file is absent,
        malformed, has fewer than 3 usable samples, or fits degenerate
        (all-zero) weights — each fallback emits a
        :class:`CalibrationWarning` naming the path taken, so a serving
        stack silently running on unmeasured weights is visible in logs
        and CI rather than only in a mis-ranked tune.
        """
        import numpy as np

        def _fall_back(reason: str) -> "CostModel":
            warnings.warn(
                f"CostModel.from_bench({path!r}): {reason}; falling back "
                f"to unmeasured paper weights (equal per-scalar costs)",
                CalibrationWarning, stacklevel=3)
            return cls(dispatch=dispatch) if fallback is None else fallback

        try:
            with open(path) as f:
                runs = json.load(f)
        except OSError as e:
            return _fall_back(f"bench trajectory unreadable ({e})")
        except ValueError as e:
            return _fall_back(f"bench trajectory is not valid JSON ({e})")
        if not isinstance(runs, list):
            return _fall_back(
                f"bench trajectory root must be a list of runs, got "
                f"{type(runs).__name__}")
        pat = re.compile(r"xi=([0-9.eE+-]+);sigma=([0-9.eE+-]+);"
                         r"zeta=([0-9.eE+-]+)")
        wire_pat = re.compile(r"wire_zeta=([0-9.eE+-]+);"
                              r"wire_us=([0-9.eE+-]+)")
        rows, ys, unknown = [], [], []
        for run in runs:
            for e in (run.get("entries", []) if isinstance(run, dict)
                      else []):
                derived = str(e.get("derived", ""))
                usable = False
                m = pat.search(derived)
                us = e.get("fused_us")
                if m and isinstance(us, (int, float)) and us > 0:
                    try:
                        rows.append([float(g) for g in m.groups()])
                        ys.append(float(us))
                        usable = True
                    except ValueError:
                        pass  # nothing appended: the row parse failed
                # transport pairs carry measured per-phase exchange legs:
                # each wire_zeta/wire_us pair is a DIRECT ζ constraint
                # (pure-communication row), so ζ is fit from real wire
                # time instead of the fused block's blended total
                for wm in wire_pat.finditer(derived):
                    try:
                        zt, wus = (float(wm.group(1)), float(wm.group(2)))
                    except ValueError:
                        continue
                    if zt > 0 and wus > 0:
                        rows.append([0.0, 0.0, zt])
                        ys.append(wus)
                        usable = True
                if not usable:
                    unknown.append(str(e.get("name", "<unnamed>")))
        fresh = sorted(set(unknown) - _WARNED_UNKNOWN)
        if fresh:
            _WARNED_UNKNOWN.update(fresh)
            warnings.warn(
                f"CostModel.from_bench({path!r}): entries contributed no "
                f"usable xi/sigma/zeta or wire_zeta/wire_us samples: "
                f"{', '.join(fresh)}", UnknownEntryWarning, stacklevel=3)
        if len(rows) < 3:
            return _fall_back(
                f"only {len(rows)} usable xi/sigma/zeta samples (need >= 3 "
                f"for the 3-weight fit)")
        # analysis: allow(host-sync): host-side lists parsed from JSON
        x = np.asarray(rows, float)
        # analysis: allow(host-sync): host-side lists parsed from JSON
        y = np.asarray(ys, float)
        scale = x.max(axis=0)
        scale[scale == 0] = 1.0
        xs = x / scale
        active = [0, 1, 2]
        w = np.zeros(3)
        while active:
            a = xs[:, active]
            g = a.T @ a + 1e-8 * len(xs) * np.eye(len(active))
            wa = np.linalg.solve(g, a.T @ y)
            neg = [i for i, wi in zip(active, wa, strict=True) if wi < 0]
            if not neg:
                w[:] = 0.0
                w[active] = wa
                break
            active = [i for i in active if i not in neg]
        w = w / scale
        if not (np.all(np.isfinite(w)) and np.any(w > 0)):
            return _fall_back(
                f"fit degenerate over {len(rows)} samples (weights "
                # analysis: allow(host-sync): w is a numpy array on the host
                f"{w.tolist()}): trajectory is collinear or zero-signal")
        return cls(computation=float(w[0]), storage=float(w[1]),
                   communication=float(w[2]), dispatch=dispatch)


DEFAULT_COST = CostModel()


# =============================================================== candidates
@dataclasses.dataclass(frozen=True)
class Candidate:
    """One ranked point of the tuner's search space."""

    scheme: str
    s: int
    t: int
    lam: Optional[int]          # explicit gap for AGE; None otherwise
    n_workers: int
    m: int                      # co-optimized coded tile side
    n_blocks: int               # batch × tiles at that side
    over_budget: bool           # True when even the coarsest side exceeds
                                # the dispatch budget (documented clamp)
    overheads: Overheads        # per coded block, at this candidate's N
    score: float                # CostModel.total over the whole workload
    placement: Optional[Tuple[int, ...]] = None  # device slot assignment
                                # when tuning over a WorkerPool

    def sort_key(self) -> Tuple:
        """Deterministic ranking: budget-respecting first, then weighted
        score, then fewest workers; ties break toward AGE and the largest
        gap (the paper's Example 1 convention)."""
        lam = -1 if self.lam is None else self.lam
        return (self.over_budget, self.score, self.n_workers,
                _SCHEME_RANK[self.scheme], self.t, self.s, -lam)


def _shape3(shape) -> Tuple[int, int, int]:
    """Normalize ``(r, k, c)`` or ``((r, k), (k, c))`` to ``(r, k, c)``."""
    shape = tuple(shape)
    if len(shape) == 2 and all(hasattr(d, "__len__") for d in shape):
        (r, k1), (k2, c) = shape
        if k1 != k2:
            raise ValueError(f"inner dims disagree: {shape}")
        shape = (r, k1, c)
    if len(shape) != 3:
        raise ValueError(
            f"shape must be (r, k, c) or ((r, k), (k, c)), got {shape!r}")
    r, k, c = (int(d) for d in shape)
    if min(r, k, c) < 1:
        raise ValueError(f"workload dims must be >= 1, got {shape!r}")
    return r, k, c


def _lam_choices(scheme: str, t: int, z: int,
                 lam: Optional[int]) -> Sequence[Optional[int]]:
    if scheme != "age":
        return (None,)           # entangled/polydot ignore the gap
    if lam is not None:
        return (lam,)
    if t == 1:
        return (0,)              # N = 2s + 2z − 1 for every gap (Lemma 14)
    return tuple(range(z + 1))   # eq. (13): search the full gap range


def _axis_range(pinned: Optional[int], limit: int) -> Sequence[int]:
    return (pinned,) if pinned is not None else range(1, limit + 1)


def _feasible(n_workers: int, z: int, schemes: Sequence[str],
              t_axis: Sequence[int], s_axis: Sequence[int],
              lam: Optional[int], adversaries: int = 0):
    """Yield every feasible family member ``(scheme, s, t, λ, N)``.

    The one enumeration path shared by :func:`search` and
    :func:`retune_spec` (only the partition axes differ: free/pinned
    ranges vs divisors of the in-flight block side): excludes the uncoded
    ``s = t = 1`` BGW case, prunes ``st > N`` before touching the code
    (``|P(H)| ⊇ P(C_A)+P(C_B)`` has at least ``st`` elements, so such a
    code can never fit), sizes the rest by the memoized degree-set
    enumeration, and keeps those within the worker budget.

    A Byzantine budget ``adversaries = a`` tightens feasibility exactly
    like the privacy budget ``z`` does (DESIGN.md §9): the code's worker
    count must also cover the verified quorum ``t²+z + 2a``, so
    partitions whose N leaves no room for liar detection are pruned here
    — before any of them can win the ranking.
    """
    for scheme in schemes:
        if scheme not in _SCHEME_RANK:
            raise ValueError(
                f"unknown scheme {scheme!r}: expected one of "
                f"{sorted(_SCHEME_RANK)}")
        for tt in t_axis:
            for ss in s_axis:
                if ss == 1 and tt == 1:
                    continue
                if ss * tt > n_workers:
                    continue
                for lm in _lam_choices(scheme, tt, z, lam):
                    n = _resolve_code(scheme, ss, tt, z, lm).n_workers
                    if n <= n_workers and (
                            n >= tt * tt + z + 2 * adversaries):
                        yield scheme, ss, tt, lm, n


def _pool_budget(n_workers: Optional[int], pool: Optional[WorkerPool],
                 within=None) -> int:
    """Resolve the worker budget from an ``int N`` and/or a pool roster
    (optionally restricted to the ``within`` device subset)."""
    if pool is not None and not isinstance(pool, WorkerPool):
        raise TypeError(f"pool must be a WorkerPool, got {pool!r}")
    if within is not None and pool is None:
        raise ValueError("within= requires a pool")
    if pool is None:
        if n_workers is None:
            raise ValueError("pass a worker budget n_workers or a pool=")
        return int(n_workers)
    avail = len(pool) if within is None else len({int(d) for d in within})
    budget = avail if n_workers is None else int(n_workers)
    if budget > avail:
        raise ValueError(
            f"worker budget {budget} exceeds the pool's {avail} available "
            f"devices")
    return budget


def search(n_workers: Optional[int] = None, z: int = None, shape=None, *,
           pool: Optional[WorkerPool] = None, within=None, batch: int = 1,
           cost: Optional[CostModel] = None,
           schemes: Sequence[str] = ("age", "entangled", "polydot"),
           s: Optional[int] = None, t: Optional[int] = None,
           lam: Optional[int] = None, adversaries: int = 0,
           tile_budget: int = DEFAULT_TILE_BUDGET,
           max_partition: int = MAX_PARTITION) -> Tuple[Candidate, ...]:
    """Enumerate + rank every feasible candidate (best first).

    Feasibility: the code's required worker count (degree-set enumeration,
    memoized) fits the ``n_workers`` budget; ``s = t = 1`` is excluded
    (uncoded BGW, paper footnote 1).  For each feasible ``(scheme, s, t,
    λ)`` the coded tile side is co-optimized against the workload shape
    through :func:`repro.mpc.tiling.block_candidates`.

    With ``pool=`` (a :class:`~repro.mpc.workers.WorkerPool`) the budget
    defaults to the roster size, each candidate gets an evaluation-point
    **placement** (its N cheapest devices under these weights, ordered
    highest-capacity into the heavy low slots), and the score scales every
    Cor. 8–10 term by the placed bottleneck — a homogeneous pool reproduces
    the legacy scores and ranking exactly.  ``within=`` restricts the
    candidate devices to a roster subset (attrition paths pass the healthy
    device ids); placements always index the *original* roster, so device
    ids stay stable across re-tunes.
    """
    budget = _pool_budget(n_workers, pool, within)
    if budget < 1:
        raise ValueError(f"worker budget must be >= 1, got {budget}")
    if z is None or z < 1:
        raise ValueError(f"privacy bound z must be >= 1, got {z}")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if adversaries < 0:
        raise ValueError(
            f"adversaries must be >= 0, got {adversaries}")
    cm = DEFAULT_COST if cost is None else cost
    r, k, c = _shape3(shape)
    out = []
    placing = cm.recalibrated_pool(pool)   # measured rates steer placement
    for scheme, ss, tt, lm, n in _feasible(
            budget, z, schemes, _axis_range(t, max_partition),
            _axis_range(s, max_partition), lam, adversaries):
        placement = None if pool is None else placing.place(n, cm,
                                                            within=within)
        m, blocks, over, sc = best_block(
            ss, tt, z, n, r, k, c, cost=cm, batch=batch,
            budget=tile_budget, pool=pool, placement=placement)
        out.append(Candidate(
            scheme=scheme, s=ss, t=tt, lam=lm, n_workers=n,
            m=m, n_blocks=blocks, over_budget=over,
            overheads=overheads(m, ss, tt, z, n), score=sc,
            placement=placement))
    out.sort(key=Candidate.sort_key)
    return tuple(out)


# ================================================================= results
@dataclasses.dataclass(frozen=True)
class TuneResult:
    """The tuner's answer: a frozen spec + the ranked search space."""

    spec: "object"                      # MPCSpec (the winning candidate)
    tile_budget: int
    shape: Tuple[int, int, int]
    batch: int
    cost: CostModel
    candidates: Tuple[Candidate, ...]   # ranked, best first

    @property
    def best(self) -> Candidate:
        return self.candidates[0]

    @property
    def predicted(self) -> Overheads:
        """Per-block Cor. 8–10 overheads of the winning candidate."""
        return self.best.overheads

    def connect(self, backend: str = "local", **opts):
        """``connect(result.spec)`` with the tuned tile budget and cost
        model pre-wired into the session."""
        from .api import connect

        opts.setdefault("tile_budget", self.tile_budget)
        opts.setdefault("cost", self.cost)
        return connect(self.spec, backend, **opts)

    def predicted_makespan(self, *, waves: float = 1.0) -> float:
        """Per-block µs makespan the tuned spec is predicted to achieve —
        :func:`predicted_makespan` under this result's cost model."""
        return predicted_makespan(self.spec, cost=self.cost, waves=waves)


def predicted_makespan(spec, *, cost: Optional[CostModel] = None,
                       waves: float = 1.0) -> float:
    """Model-predicted per-block µs makespan of a tuned spec — THE number
    the fleet simulator's divergence gate compares against a replay
    (DESIGN.md §11).

    Evaluates :func:`repro.mpc.workers.modeled_makespan` on the spec's
    pool (recalibrated by the cost model's class multipliers, when set)
    at the spec's effective placement, adversary budget and the given
    backend wave count (:func:`repro.mpc.workers.dispatch_waves`).
    Requires a pool-carrying spec — there is no per-slot makespan to
    predict for the abstract ``int N`` budget.
    """
    from .workers import modeled_makespan

    if spec.pool is None:
        raise ValueError(
            "predicted_makespan requires a spec carrying a WorkerPool "
            "(tune(pool=...)); an int worker budget has no device rates "
            "to predict with")
    cm = DEFAULT_COST if cost is None else cost
    pool = cm.recalibrated_pool(spec.pool)
    placement = spec.effective_placement
    if placement is None:
        placement = pool.place(spec.n_workers, cm)
    return modeled_makespan(
        spec.m, spec.s, spec.t, spec.z, spec.n_workers, cm, pool,
        placement, adversaries=spec.adversaries, waves=waves)


def tune(n_workers: Optional[int] = None, z: int = None, shape=None, *,
         pool: Optional[WorkerPool] = None, within=None, batch: int = 1,
         cost: Optional[CostModel] = None,
         schemes: Sequence[str] = ("age", "entangled", "polydot"),
         s: Optional[int] = None, t: Optional[int] = None,
         lam: Optional[int] = None, adversaries: int = 0,
         field: Field = DEFAULT_FIELD,
         tile_budget: int = DEFAULT_TILE_BUDGET,
         max_partition: int = MAX_PARTITION) -> TuneResult:
    """Solve the paper's optimization layer for one workload.

    Parameters
    ----------
    n_workers : the worker budget N (available edge devices); defaults to
                the roster size when a ``pool`` is given
    z         : collusion/privacy bound
    shape     : ``(r, k, c)`` or ``((r, k), (k, c))`` — the workload
                ``[r,k]×[k,c]``
    pool      : optional :class:`~repro.mpc.workers.WorkerPool` — the
                heterogeneous roster; the objective becomes per-worker
                weighted and the winning spec carries the pool plus the
                co-optimized evaluation-point placement
    within    : optional device-id subset of ``pool`` to place on (the
                attrition paths pass the healthy devices; ids stay
                original-roster-indexed)
    batch     : leading batch depth (multiplies the block count)
    cost      : :class:`CostModel` weights (default: equal weights, no
                dispatch term — the pure Fig. 3 objective)
    schemes   : code families to search
    s, t, lam : pin any of the partition / gap axes (e.g. validation
                against the Theorem-3 grid pins ``s`` and ``t``)
    adversaries : Byzantine budget ``a`` (DESIGN.md §9) — treated like
                ``z`` during feasibility: candidates must provide
                ``N ≥ t²+z+2a`` workers, and the winning spec carries the
                budget (its decodes run MAC-verified)
    field     : prime field + fixed-point config for the returned spec
    tile_budget : dispatch cap forwarded to block co-optimization and to
                sessions opened via :meth:`TuneResult.connect`

    Raises ``ValueError`` when no candidate fits the budget (the family
    minimum exceeds ``n_workers``).
    """
    from .api import MPCSpec

    if tile_budget < 1:
        raise ValueError(f"tile budget must be >= 1, got {tile_budget}")
    cands = search(n_workers, z, shape, pool=pool, within=within,
                   batch=batch, cost=cost, schemes=schemes, s=s, t=t,
                   lam=lam, adversaries=adversaries,
                   tile_budget=tile_budget, max_partition=max_partition)
    if not cands:
        raise ValueError(
            f"no feasible spec: worker budget "
            f"N={_pool_budget(n_workers, pool, within)} is below the "
            f"family minimum for z={z}, a={adversaries} "
            f"(schemes={tuple(schemes)})")
    best = cands[0]
    spec = MPCSpec(s=best.s, t=best.t, z=z, lam=best.lam,
                   scheme=best.scheme, field=field, m=best.m,
                   pool=pool, placement=best.placement,
                   adversaries=adversaries)
    r, k, c = _shape3(shape)
    # the winner's m is baked into the spec and bypasses the session's
    # block search, so the documented over-budget clamp must warn HERE —
    # same TileBudgetWarning contract as choose_block_cost
    _check_budget(best.m, best.n_blocks, tile_budget, (r, k, c), batch)
    return TuneResult(spec=spec, tile_budget=tile_budget, shape=(r, k, c),
                      batch=batch, cost=cost or DEFAULT_COST,
                      candidates=cands)


# ============================================================ attrition path
def retune_spec(n_workers: Optional[int] = None, z: int = None, *, m: int,
                pool: Optional[WorkerPool] = None, within=None,
                field: Field = DEFAULT_FIELD,
                cost: Optional[CostModel] = None,
                schemes: Sequence[str] = ("age",),
                adversaries: int = 0,
                max_partition: Optional[int] = None):
    """Best spec decodable with the survivors at a *fixed* block side
    ``m`` (shares were already tiled for it), or ``None``.

    The attrition-time tune: candidates are restricted to partitions that
    divide ``m`` (the protocol cannot re-tile in-flight data), the worker
    budget is the surviving pool, and ranking is the same weighted Cor.
    8–10 objective on the single fixed block.  The elastic layer tries
    this *before* the legacy greedy ``replan`` (DESIGN.md §7).

    ``pool`` + ``within``, when given, are the original roster and the
    **surviving** device ids (the elastic layer passes
    :meth:`repro.mpc.elastic.ElasticPool.surviving_devices`): the budget
    defaults to the survivor count, every candidate is placed on the
    cheapest surviving devices and scored per-worker-weighted, and the
    returned spec keeps the original roster — device ids stay stable
    across re-tunes, so failure routing never re-bases.

    ``max_partition`` defaults to the same :data:`MAX_PARTITION` bound
    :func:`tune` searches under — this sits on the serving path, and
    enumerating degree sets for every large divisor of ``m`` would stall
    a flush (``N ≥ st`` anyway, so partitions past a shrunken pool's size
    can never fit).  Pass it explicitly to widen the search offline.
    """
    from .api import MPCSpec

    budget = _pool_budget(n_workers, pool, within)
    if z is None or z < 1:
        raise ValueError(f"privacy bound z must be >= 1, got {z}")
    if adversaries < 0:
        raise ValueError(
            f"adversaries must be >= 0, got {adversaries}")
    cm = DEFAULT_COST if cost is None else cost
    limit = min(m, MAX_PARTITION if max_partition is None else max_partition)
    divisors = [d for d in range(1, limit + 1) if m % d == 0]
    best: Optional[Tuple[Tuple, Candidate]] = None
    placing = cm.recalibrated_pool(pool)
    for scheme, ss, tt, lm, n in _feasible(budget, z, schemes,
                                           divisors, divisors, None,
                                           adversaries):
        placement = None if pool is None else placing.place(n, cm,
                                                            within=within)
        cand = Candidate(
            scheme=scheme, s=ss, t=tt, lam=lm, n_workers=n,
            m=m, n_blocks=1, over_budget=False,
            overheads=overheads(m, ss, tt, z, n),
            score=cm.total(m, ss, tt, z, n, 1, pool=pool,
                           placement=placement),
            placement=placement)
        key = cand.sort_key()
        if best is None or key < best[0]:
            best = (key, cand)
    if best is None:
        return None
    c = best[1]
    return MPCSpec(s=c.s, t=c.t, z=z, lam=c.lam, scheme=c.scheme,
                   field=field, m=m, pool=pool, placement=c.placement,
                   adversaries=adversaries)
