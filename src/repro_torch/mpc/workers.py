"""First-class heterogeneous worker pools (DESIGN.md §8).

The paper targets *edge* networks: the N workers are phones, gateways and
micro-servers with wildly different compute / storage / link budgets.  Every
layer above this module used to model the pool as a bare homogeneous count
``N``; this module is the capacity-vector view those layers now share:

* :class:`WorkerClass` — one device class's capacity vector, expressed as
  *relative per-scalar cost rates* against a unit reference device:
  ``compute`` (µs per scalar multiplication, the ξ rate of eq. (15)),
  ``storage`` (cost per scalar stored, the σ rate of eq. (16)) and ``link``
  (µs per scalar on the wire — inverse bandwidth, the ζ rate of eq. (17)).
  Absolute µs-per-scalar units come from the calibrated cost model
  (:meth:`repro.mpc.autotune.CostModel.from_bench`); classes only say how
  much slower one device is than another.
* :class:`WorkerPool` — a frozen, ordered roster of device classes.  The
  tuner's budget is ``len(pool)``; a **placement** is the ordered tuple of
  roster indices assigned to protocol worker slots ``0..N-1``.
  :meth:`WorkerPool.place` selects and orders the assignment
  (cheapest-composite devices first, ties toward the lower roster index —
  so a homogeneous pool places the identity prefix and stays bit- and
  key-compatible with the legacy ``int N`` paths), :meth:`WorkerPool
  .bottleneck` yields the per-resource slowdown factors the weighted
  Cor. 8–10 objective scales by, and :meth:`WorkerPool.spares_for` orders
  the unplaced remainder highest-capacity-first for elastic spare
  provisioning.

Placement contract (DESIGN.md §8): low protocol slots are the *heavy*
slots — the default decode quorum is the first ``t²+z`` slots (they upload
their ``I(α_n)`` block to the master and are the survivor-prefix decode
preference), so :meth:`place` puts the highest-capacity devices there.
Placement permutes which physical device serves which slot; it never
changes the protocol tables, so placement-qualified plan keys alias one
shared :class:`~repro.mpc.planner.ProtocolPlan`.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Optional, Sequence, Tuple

from ..core.overheads import overheads

_UNIT = (1.0, 1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class WorkerClass:
    """One device class's capacity vector (relative per-scalar cost rates).

    ``compute``: µs per scalar multiplication relative to the reference
    device (2.0 = half the FLOP rate); ``storage``: relative cost per
    scalar stored (capture DRAM/flash scarcity); ``link``: relative µs per
    scalar on the wire (2.0 = half the bandwidth).  All rates must be > 0
    — a zero-rate device would make every placement through it free and
    the bottleneck objective degenerate.
    """

    name: str = "generic"
    compute: float = 1.0
    storage: float = 1.0
    link: float = 1.0

    def __post_init__(self):
        for attr in ("compute", "storage", "link"):
            v = getattr(self, attr)
            if not (isinstance(v, (int, float)) and v > 0):
                raise ValueError(
                    f"WorkerClass.{attr} must be > 0, got {v!r}")

    @property
    def key(self) -> Tuple:
        """Hashable signature (grouping identity across equal classes)."""
        return (self.name, float(self.compute), float(self.storage),
                float(self.link))

    def unit_cost(self, weights=None) -> float:
        """Composite per-scalar cost under one set of objective weights.

        ``weights`` is anything with ``computation`` / ``storage`` /
        ``communication`` attributes (a :class:`~repro.mpc.autotune
        .CostModel`); ``None`` weighs the three rates equally.
        """
        wc, ws, wl = (_UNIT if weights is None else
                      (weights.computation, weights.storage,
                       weights.communication))
        return wc * self.compute + ws * self.storage + wl * self.link


#: unit reference device — a pool of these is exactly the legacy ``int N``
GENERIC = WorkerClass()
#: presets for examples/benchmarks (rates are illustrative, not measured)
EDGE_SERVER = WorkerClass("edge-server", compute=1.0, storage=1.0, link=1.0)
GATEWAY = WorkerClass("gateway", compute=3.0, storage=2.0, link=4.0)
PHONE = WorkerClass("phone", compute=10.0, storage=8.0, link=25.0)


@dataclasses.dataclass(frozen=True)
class WorkerPool:
    """A frozen, ordered roster of edge devices (one class per slot).

    The roster index is the *device id*; a placement maps protocol worker
    slots onto device ids.  Hashable, so it can live inside
    :class:`~repro.mpc.api.MPCSpec` and key engine groups.
    """

    workers: Tuple[WorkerClass, ...]

    def __post_init__(self):
        ws = tuple(self.workers)
        if not ws:
            raise ValueError("WorkerPool needs at least one worker")
        for w in ws:
            if not isinstance(w, WorkerClass):
                raise TypeError(f"pool entries must be WorkerClass, got {w!r}")
        object.__setattr__(self, "workers", ws)

    # ---------------------------------------------------------- constructors
    @classmethod
    def homogeneous(cls, n: int, klass: WorkerClass = GENERIC) -> "WorkerPool":
        """``n`` identical devices — the legacy ``int N`` budget as a pool."""
        if n < 1:
            raise ValueError(f"pool size must be >= 1, got {n}")
        return cls(workers=(klass,) * n)

    @classmethod
    def of(cls, *groups: Tuple[WorkerClass, int]) -> "WorkerPool":
        """``WorkerPool.of((GATEWAY, 4), (PHONE, 12))`` — class-count pairs,
        roster-ordered as given."""
        ws = []
        for klass, count in groups:
            if count < 0:
                raise ValueError(f"negative count for {klass!r}: {count}")
            ws.extend([klass] * count)
        return cls(workers=tuple(ws))

    # -------------------------------------------------------------- protocol
    def __len__(self) -> int:
        return len(self.workers)

    def __iter__(self):
        return iter(self.workers)

    def __getitem__(self, i: int) -> WorkerClass:
        return self.workers[i]

    @property
    def key(self) -> Tuple:
        """Hashable pool signature — the ``pool_key`` engine groups carry."""
        return tuple(w.key for w in self.workers)

    @property
    def is_homogeneous(self) -> bool:
        first = self.workers[0].key[1:]
        return all(w.key[1:] == first for w in self.workers)

    # ------------------------------------------------------------- placement
    def unit_costs(self, weights=None) -> Tuple[float, ...]:
        """Per-device composite per-scalar cost under one weight set."""
        return tuple(w.unit_cost(weights) for w in self.workers)

    def place(self, n: int, weights=None,
              within: Optional[Iterable[int]] = None) -> Tuple[int, ...]:
        """Select + order ``n`` devices for protocol slots ``0..n-1``.

        Selection keeps the ``n`` cheapest devices under the composite
        per-scalar cost; ordering is cheapest-first so the heavy low slots
        (default decode quorum / survivor-prefix preference) land on the
        highest-capacity devices.  Ties break toward the lower roster
        index, so a homogeneous pool places the identity prefix
        ``(0, …, n-1)`` — the bit- and key-compatibility anchor of the
        legacy ``int N`` paths.  ``within`` restricts candidates (e.g. the
        surviving device set at re-tune time).
        """
        cand = range(len(self.workers)) if within is None else \
            sorted({int(d) for d in within})
        cand = list(cand)
        for d in cand:
            if not 0 <= d < len(self.workers):
                raise ValueError(f"device id {d} outside pool of "
                                 f"{len(self.workers)}")
        if n < 1 or n > len(cand):
            raise ValueError(
                f"cannot place {n} workers on {len(cand)} devices")
        u = self.unit_costs(weights)
        order = sorted(cand, key=lambda d: (u[d], d))
        return tuple(order[:n])

    def bottleneck(self, placement: Sequence[int]
                   ) -> Tuple[float, float, float]:
        """Worst per-resource slowdown over the placed devices: the
        ``(max compute, max storage, max link)`` factors that scale ξ/σ/ζ
        in the pool-weighted objective.  Unit classes give ``(1, 1, 1)``
        exactly, so homogeneous scores equal the legacy ones bit-for-bit.
        """
        if not placement:
            raise ValueError("empty placement")
        ws = [self.workers[int(d)] for d in placement]
        return (max(w.compute for w in ws), max(w.storage for w in ws),
                max(w.link for w in ws))

    def spares_for(self, placement: Sequence[int],
                   weights=None) -> Tuple[int, ...]:
        """Unplaced devices ordered highest-capacity (cheapest) first —
        the elastic layer's spare-provisioning preference."""
        placed = {int(d) for d in placement}
        u = self.unit_costs(weights)
        rest = [d for d in range(len(self.workers)) if d not in placed]
        return tuple(sorted(rest, key=lambda d: (u[d], d)))

    def describe(self) -> str:
        """Compact roster summary for demos/logs: ``4×gateway + 12×phone``."""
        runs = []
        for w in self.workers:
            if runs and runs[-1][0] == w.name:
                runs[-1][1] += 1
            else:
                runs.append([w.name, 1])
        return " + ".join(f"{c}×{nm}" for nm, c in runs)

    # ----------------------------------------------------------- calibration
    def recalibrated(self, multipliers: Mapping[str, Sequence[float]]
                     ) -> "WorkerPool":
        """This roster with measured per-class ``(ξ, σ, ζ)`` multipliers
        applied to the hand-set rates (DESIGN.md §11).

        ``multipliers`` maps a class *name* to the three per-resource
        factors a calibration fit recovered
        (:func:`repro.sim.calibrate.fit_class_multipliers`); classes not in
        the map keep their rates.  Roster order — and therefore every
        device id and placement — is preserved, so a recalibrated pool is
        a drop-in replacement wherever the original was used.
        """
        ws = []
        for w in self.workers:
            mc, ms_, ml = multipliers.get(w.name, _UNIT)
            ws.append(WorkerClass(name=w.name, compute=w.compute * mc,
                                  storage=w.storage * ms_, link=w.link * ml))
        return WorkerPool(workers=tuple(ws))

    def modeled_makespan(self, m: int, s: int, t: int, z: int, n: int,
                         cost, placement: Sequence[int],
                         adversaries: int = 0, waves: float = 1.0) -> float:
        """Per-slot µs makespan for one coded block on this roster — the
        method form of :func:`modeled_makespan` (one shared formula for the
        model, the bench pairs and the fleet simulator)."""
        return modeled_makespan(m, s, t, z, n, cost, self, placement,
                                adversaries=adversaries, waves=waves)


def dispatch_waves(n_workers: int, axis_size: Optional[int]) -> int:
    """Serialized worker waves one block dispatch pays: ``ceil(N / D)``
    when the N logical workers pack onto a ``D``-device mesh axis
    round-robin (``ShardedBackend.dispatch_scale``), 1 when every worker
    has its own lane (``axis_size=None``).  The one wave formula shared by
    the backend's dispatch scale, :func:`modeled_makespan` and the fleet
    simulator's replay clock (DESIGN.md §11)."""
    if axis_size is None:
        return 1
    d = int(axis_size)
    if d < 1:
        raise ValueError(f"axis_size must be >= 1, got {axis_size}")
    return -(-int(n_workers) // d)


def slot_scalars(m: int, s: int, t: int, z: int, n: int,
                 n_slots: int, adversaries: int = 0
                 ) -> Tuple[Tuple[float, float, float], ...]:
    """Raw per-slot ``(ξ, σ, comm)`` scalar counts for one coded block —
    device-independent work units.

    ξ and σ are the Cor. 8–10 per-worker counts; the communication
    column is slot-dependent: every slot pays the ``(N−1)·m²/t²``
    all-pairs phase-2 exchange, and the first ``t²+z(+2a)`` slots (the
    decode quorum; the verified quorum under an adversary budget,
    DESIGN.md §9) one extra ``m²/t²`` upload of their ``I(α)`` block to
    the master.  :func:`slot_times` turns these into µs; the fleet
    simulator records them as the ``scalars`` column of its phase
    samples so calibration can normalize measured time by work
    (DESIGN.md §11).
    """
    ov = overheads(m, s, t, z, n)
    per_worker_comm = (n - 1) * m * m / (t * t)
    upload = m * m / (t * t)
    t2z = t * t + z + 2 * adversaries
    return tuple(
        (ov.computation, ov.storage,
         per_worker_comm + (upload if slot < t2z else 0.0))
        for slot in range(n_slots))


def slot_times(m: int, s: int, t: int, z: int, n: int, cost,
               pool: WorkerPool, placement: Sequence[int],
               adversaries: int = 0
               ) -> Tuple[Tuple[float, float, float], ...]:
    """Per-slot ``(compute, storage, communication)`` µs triples for one
    coded ``m×m`` block — THE per-slot cost formula.

    Slot ``i`` on device ``d = placement[i]`` pays the
    :func:`slot_scalars` work units scaled by the cost model's µs/scalar
    weights and the device's per-resource rates.

    :func:`modeled_makespan` reduces these triples to the slowest slot;
    the fleet simulator (:mod:`repro.sim.replay`) multiplies exactly the
    same triples by per-device truth multipliers and jitter — so the
    modeled and the simulated makespan share one formula by construction,
    and divergence between them measures *calibration* error, never
    formula drift (DESIGN.md §11).
    """
    raw = slot_scalars(m, s, t, z, n, len(placement), adversaries)
    out = []
    for (xi, sg, comm), dev in zip(raw, placement, strict=True):
        w = pool.workers[int(dev)]
        out.append((cost.computation * xi * w.compute,
                    cost.storage * sg * w.storage,
                    cost.communication * comm * w.link))
    return tuple(out)


def modeled_makespan(m: int, s: int, t: int, z: int, n: int, cost,
                     pool: WorkerPool, placement: Sequence[int],
                     adversaries: int = 0, waves: float = 1.0) -> float:
    """Per-slot µs makespan estimate for one coded ``m×m`` block.

    The per-slot refinement of the ranking objective (which is the
    conservative bottleneck bound — see :meth:`repro.mpc.autotune.CostModel
    .block`): the slowest slot's ``(compute + storage + communication)``
    total over the :func:`slot_times` triples.  This is the measured-win
    metric of the ``hetero_tune_*`` bench pairs: under it, placement
    *ordering* matters (the quorum term), not only device selection.

    ``waves`` folds the backend's dispatch wave structure into the model
    (DESIGN.md §8): a backend that serializes its worker phases —
    ``ceil(N/D)`` mesh waves on the sharded runner
    (:func:`dispatch_waves`, ``ShardedBackend.dispatch_scale``) — pays the
    worst slot once per wave, so the block completes at ``waves ×`` the
    single-wave makespan.  The default 1.0 is the all-lanes-parallel
    local/batched model and keeps legacy call sites bit-identical.

    With an adversary budget (``adversaries > 0``) the master reads the
    wider verified quorum ``t²+z+2a`` — those extra uploads carry the
    MAC-checked redundancy that localizes liars (DESIGN.md §9).
    """
    if waves < 1.0:
        raise ValueError(f"waves must be >= 1, got {waves}")
    times = slot_times(m, s, t, z, n, cost, pool, placement,
                       adversaries=adversaries)
    return waves * max(sum(triple) for triple in times)
