"""Batched CMPC request serving on torch (port of ``repro/mpc/engine.py``).

:class:`MPCEngine` turns a queue of ``Y = AᵀB`` requests into the fewest
kernel launches:

* **Grouping**: queued requests bucket by serving-group key (the plan key,
  extended for pools and adversary budgets); a group shares one plan.
* **Waves**: each group is served round-robin, one wave per turn (FIFO
  within a group), healthy groups before degraded ones (pool below N, or
  escalated to a replan: ``stats["deferred_groups"]``).  The wave width
  adapts to the plan's per-request scalar cost (:func:`wave_width`):
  small blocks take wide waves, large ones width 1, served through the
  plan's fused single-request path.  Tails split exactly
  (:func:`_next_wave`), and the padding left is ``stats["padded_lanes"]``:
  padded lanes repeat the last request and are computed, as in the
  reference, so the counters are equal.
* **Batched phases 1–2**: a wave runs the plan's ``vfront`` stage, one
  launch per stage for all its lanes (3 ``polyeval``, 1
  ``modmatmul_batched``); each lane draws from its own request's key, so a
  request's I-points do not depend on its wave.
* **Per-request dropout**: decode sub-groups the wave by survivor prefix,
  one ``vdecode`` launch per pattern, rows from the plan's survivor LRU.
* **Replan escalation**: each group may be backed by an
  :class:`~repro_torch.mpc.elastic.ElasticPool`; dead pool workers among
  the first N fold into every mask, and a pool below N escalates, re-tune
  first (:meth:`ElasticPool.retune`), greedy replan second.
* **Failure isolation**: an unservable request lands in
  :attr:`MPCEngine.failures` with a reason; the rest are served.
* **Byzantine verification**: groups with an adversary budget MAC-tag
  every share with one skinny ``vtags`` launch per wave, run the optional
  :class:`~repro_torch.mpc.byzantine.FaultInjector` on the device, tag
  again, and exclude liars before decode; the honesty mask's trip to the
  host is the one sync control flow needs.  A caught liar is evicted from
  the group's pool.

The engine runs on the device it is given (``device=``): the card by
default, the CPU only when asked.  Results are tensors on that device.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

import numpy as np
import torch

from . import byzantine as byz
from .api import MPCSpec
from .elastic import ElasticPool
from .errors import AdversaryBudgetError, QuorumError
from .field import DEFAULT_FIELD, Field, as_int64, resolve_device
from .planner import PlanKey
from .protocol import AGECMPCProtocol


@dataclasses.dataclass(frozen=True)
class MPCRequest:
    """One queued ``Y = AᵀB`` evaluation (internal to the engine)."""

    rid: int
    a: torch.Tensor
    b: torch.Tensor
    key: object                      # int seed or torch.Generator
    proto: AGECMPCProtocol
    survivors: Optional[np.ndarray]  # bool [N] or None (all alive)


def _resolve_proto(spec: Optional[MPCSpec], m: Optional[int], s, t, z,
                   lam, scheme, field) -> AGECMPCProtocol:
    """One protocol from a spec (+ optional block override) or the kwarg
    blob the reference still takes."""
    if spec is not None:
        return AGECMPCProtocol.from_spec(spec, m=m)
    if s is None or t is None or z is None or m is None:
        raise TypeError("pass spec=MPCSpec(...) or all of s, t, z, m")
    return AGECMPCProtocol.from_spec(
        MPCSpec(s=s, t=t, z=z, lam=lam, scheme=scheme, field=field, m=m))


def _pad_pow2(n: int, cap: int) -> int:
    """Smallest power of two ≥ n, capped (bounds per-plan recompiles)."""
    out = 1
    while out < n:
        out *= 2
    return min(out, cap)


def _pow2_floor(n: int) -> int:
    """Largest power of two ≤ n (n ≥ 1)."""
    out = 1
    while out * 2 <= n:
        out *= 2
    return out


def _next_wave(n: int, cap: int) -> int:
    """How many of ``n`` queued requests the next wave serves (≤ cap).

    Full waves take ``cap`` lanes.  A tail keeps its pow2 pad only when
    the padding costs ≤ wave/4 lanes; otherwise it splits at the largest
    power of two so padded lanes never exceed the exact-tail split (a
    17-request group runs 16+1 lanes, never 32)."""
    if n >= cap:
        return cap
    p = _pad_pow2(n, cap)
    if (p - n) * 4 <= p:
        return n
    return _pow2_floor(n)


#: default per-wave scalar budget (also the class attribute
#: ``MPCEngine.WAVE_SCALARS``): wide enough that dispatch-bound small-m
#: groups keep max_batch-wide vmapped waves, tight enough that
#: compute-bound m≳128 groups degrade to the fused width-1 path
WAVE_SCALARS = 256_000


def request_scalars(spec) -> int:
    """Per-request scalar cost one wave lane pays under this spec: the
    N interpolation points (``(m/t)²`` each) plus the two ``m×m``
    operands.  The admission unit of the adaptive wave width — and the
    per-lane work unit the fleet simulator replays (DESIGN.md §10/§11)."""
    return (spec.n_workers * (spec.m // spec.t) ** 2
            + 2 * spec.m * spec.m)


def wave_width(spec, *, max_batch: int,
               wave_scalars: Optional[int] = None,
               inflight: Optional[int] = None) -> int:
    """Lanes per wave for one serving group (a power of two ≤ max_batch).

    THE wave-admission width formula, shared by :meth:`MPCEngine
    ._wave_width` and the fleet simulator's replay of it
    (:mod:`repro.sim.replay`): ``inflight`` (when set) is a hard
    per-turn budget; otherwise the width keeps ``lanes ×``
    :func:`request_scalars` under ``wave_scalars`` (small-m groups are
    dispatch-bound and batch wide, compute-bound large-m groups degrade
    to width 1 and take the fused path); ``wave_scalars=None`` restores
    legacy fixed-width waves.
    """
    if inflight is not None:
        w = inflight
    elif wave_scalars is None:
        return max_batch
    else:
        w = max(1, wave_scalars // request_scalars(spec))
    return _pow2_floor(min(w, max_batch))


@dataclasses.dataclass
class _GroupQueue:
    """One serving group's FIFO queue during a flush."""

    proto: AGECMPCProtocol     # protocol the group is served under
    replanned: bool            # serving key differs from submit key
    queue: "deque[MPCRequest]"
    width: int = 1             # wave width, computed once per flush


class MPCEngine:
    """Batched MPC request engine: queue, group, batch, decode, escalate."""

    #: default per-wave scalar budget (module-level :data:`WAVE_SCALARS`)
    WAVE_SCALARS = WAVE_SCALARS

    def __init__(self, *, spares: int = 2, max_batch: int = 64, cost=None,
                 injector=None, wave_scalars: Optional[int] = WAVE_SCALARS,
                 inflight: Optional[int] = None, recorder=None, device=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if inflight is not None and inflight < 1:
            raise ValueError(f"inflight must be >= 1, got {inflight}")
        self.device = resolve_device(device)
        self.spares = spares
        self.max_batch = max_batch
        # adaptive wave width (None: fixed max_batch-wide waves)
        self.wave_scalars = wave_scalars
        # hard per-group lanes per round-robin turn; overrides the width
        self.inflight = inflight
        # CostModel for attrition-time re-tuning (None: default weights);
        # stats["replans"] counts every escalation, stats["retunes"] the
        # ones the cost-model search won
        self.cost = cost
        # optional FaultInjector for verified groups, keyed by request id
        self.injector = injector
        # optional phase-timing sink (duck-typed ``record(**kw)``): each
        # wave's front/decode/fused dispatch is synchronised and recorded
        # with its scalar count; None keeps the path free of syncs
        self.recorder = recorder
        self._queue: List[MPCRequest] = []
        self._pools: Dict[PlanKey, ElasticPool] = {}
        self._replans: Dict[PlanKey, AGECMPCProtocol] = {}
        self._next_rid = 0
        self.stats = {"batches": 0, "replans": 0, "retunes": 0,
                      "drains": 0, "masks_dropped": 0, "failed": 0,
                      "corrections": 0, "evicted_devices": 0,
                      "waves": 0, "padded_lanes": 0, "deferred_groups": 0}
        self.failures: Dict[int, str] = {}
        self._new_liars: set = set()

    # --------------------------------------------------------- byzantine
    def byzantine_stats(self) -> Dict[str, int]:
        """Cumulative verified-decode counters (mirrored by the session)."""
        return {"corrections": self.stats["corrections"],
                "evicted_devices": self.stats["evicted_devices"]}

    def take_new_liars(self) -> set:
        """Drain the liar ids caught since the last call: roster device ids
        for pool-backed groups, protocol slots otherwise."""
        out, self._new_liars = self._new_liars, set()
        return out

    # ------------------------------------------------------------- pools
    def pool(self, *, spec: Optional[MPCSpec] = None, s: int = None,
             t: int = None, z: int = None, m: int = None,
             lam: Optional[int] = None, scheme: str = "age",
             field: Field = DEFAULT_FIELD) -> ElasticPool:
        """The elastic pool backing one serving group (created lazily)."""
        proto = _resolve_proto(spec, m, s, t, z, lam, scheme, field)
        key = proto.group_key
        pool = self._pools.get(key)
        if pool is None:
            pool = self._pools[key] = ElasticPool.from_spec(
                proto.spec, spares=self.spares)
        return pool

    def fail(self, workers, *, spec: Optional[MPCSpec] = None,
             s: int = None, t: int = None, z: int = None, m: int = None,
             lam: Optional[int] = None, scheme: str = "age",
             field: Field = DEFAULT_FIELD) -> None:
        """Report worker attrition for one group's pool: protocol slots for
        pool-free specs, roster device ids for pool specs."""
        pool = self.pool(spec=spec, s=s, t=t, z=z, m=m, lam=lam,
                         scheme=scheme, field=field)
        if pool.device_map is not None:
            pool.fail_devices(workers)
        else:
            pool.fail(workers)

    # ------------------------------------------------------------- queue
    def submit(self, a, b, *, key, spec: Optional[MPCSpec] = None,
               s: int = None, t: int = None, z: int = None, m: int = None,
               survivors: Optional[np.ndarray] = None,
               lam: Optional[int] = None, scheme: str = "age",
               field: Field = DEFAULT_FIELD) -> int:
        """Queue one ``Y = AᵀB`` request; returns its request id.

        ``key`` is an int seed or a ``torch.Generator`` on the engine's
        device; ``survivors`` (bool [N]) is this request's decode mask,
        validated against the submit-time spec."""
        proto = _resolve_proto(spec, m, s, t, z, lam, scheme, field)
        if survivors is not None:
            # analysis: allow(host-sync): submit-time mask, host data already
            survivors = np.asarray(survivors, bool)
            proto.spec.validate_survivors(survivors)  # shape + threshold
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(MPCRequest(
            rid=rid, a=as_int64(a, self.device), b=as_int64(b, self.device),
            key=key, proto=proto, survivors=survivors))
        return rid

    def pending(self) -> int:
        return len(self._queue)

    # ------------------------------------------------------------- flush
    def serving_proto(self, proto: AGECMPCProtocol) -> AGECMPCProtocol:
        """The protocol ``proto``'s group is currently served under (raises
        :class:`~repro_torch.mpc.errors.QuorumError` when the pool is
        infeasible and no coarser partitioning fits)."""
        return self._serving_proto(proto.group_key, proto)

    def _serving_proto(self, key: PlanKey, proto: AGECMPCProtocol
                       ) -> AGECMPCProtocol:
        """Resolve the protocol a group is served under, escalating
        (memoized) while the backing pool is below N: re-tune first
        (:meth:`ElasticPool.retune` under :attr:`cost`), greedy replan if
        no tuned candidate fits."""
        for _ in range(len(self._pools) + 2):  # escalation chains are short
            replanned = self._replans.get(key)
            if replanned is not None:
                key, proto = replanned.group_key, replanned
                continue
            pool = self._pools.get(key)
            if pool is None or pool.alive.sum() >= proto.n_workers:
                return proto
            new = pool.retune(self.cost)
            if new is not None:
                self.stats["retunes"] += 1
            else:
                new = pool.replan()
            if new is None:
                raise QuorumError(
                    f"pool for {key} infeasible ({int(pool.alive.sum())} "
                    f"alive) and no coarser partitioning fits",
                    quorum=proto.n_workers, alive=int(pool.alive.sum()))
            self._replans[key] = new
            self.stats["replans"] += 1
        raise RuntimeError("replan escalation did not converge")

    def drain_spec(self, spec: MPCSpec, shape, *, batch: int = 1,
                   cost=None, tile_budget=None) -> Optional[MPCSpec]:
        """Free re-tune for queued, not yet tiled work after attrition, or
        ``None``: when this group's pool is below N, re-solve the whole
        optimization layer for the survivors (every healthy roster device
        for a pool spec) against the queued workload's shape, any block
        side; the tuned spec is returned only when its block side differs
        (``stats["drains"]``)."""
        from .autotune import tune as _tune

        if spec.m is None:
            return None
        proto = AGECMPCProtocol.from_spec(spec)
        pool = self._pools.get(proto.group_key)
        if pool is None or int(pool.alive.sum()) >= proto.n_workers:
            return None
        cm = self.cost if cost is None else cost
        kw = dict(cost=cm, schemes=(spec.scheme,), field=spec.field,
                  batch=batch)
        if tile_budget is not None:
            kw["tile_budget"] = int(tile_budget)
        try:
            if spec.pool is not None:
                res = _tune(z=spec.z, shape=shape, pool=spec.pool,
                            within=pool.healthy_devices(), **kw)
            else:
                res = _tune(int(pool.alive.sum()), spec.z, shape, **kw)
        except ValueError:  # nothing fits the survivors: escalation will
            return None     # handle (or fail) the already-tiled path
        new = res.spec
        if new.m == spec.m:
            return None
        self.stats["drains"] += 1
        return new

    def _fail_request(self, req: MPCRequest, reason: str) -> None:
        self.failures[req.rid] = reason
        self.stats["failed"] += 1

    def _evict_liars(self, proto: AGECMPCProtocol, slots) -> None:
        """A caught liar is attrition: kill its pool slot (fail → retune →
        replan engages on the next flush) and record its roster device id
        (slot id without a roster) for :meth:`take_new_liars`."""
        key = proto.group_key
        pool = self._pools.get(key)
        if pool is None:
            pool = self._pools[key] = ElasticPool.from_spec(
                proto.spec, spares=self.spares)
        fresh = [int(s) for s in slots if pool.alive[int(s)]]
        if not fresh:
            return
        pool.fail(fresh)
        devs = (fresh if pool.device_map is None
                else [int(pool.device_map[s]) for s in fresh])
        self.stats["evicted_devices"] += len(devs)
        self._new_liars.update(devs)

    def flush(self) -> Dict[int, torch.Tensor]:
        """Serve every queued request; returns ``{rid: Y}``.

        Groups are served healthy first, degraded after, round-robin one
        wave per turn.  Failures are isolated: a request whose effective
        mask falls below its quorum, or a group whose pool is infeasible,
        lands in :attr:`failures` (``rid → reason``, replaced each flush)
        and ``stats["failed"]``; every other request is served.
        """
        queue, self._queue = self._queue, []
        groups: "OrderedDict[PlanKey, List[MPCRequest]]" = OrderedDict()
        for req in queue:
            groups.setdefault(req.proto.group_key, []).append(req)
        results: Dict[int, torch.Tensor] = {}
        self.failures = {}
        healthy: List[_GroupQueue] = []
        degraded: List[_GroupQueue] = []
        for key, reqs in groups.items():
            try:
                serving = self._serving_proto(key, reqs[0].proto)
            except RuntimeError as e:
                for req in reqs:
                    self._fail_request(req, str(e))
                continue
            replanned = serving.group_key != key
            pool = self._pools.get(serving.group_key)
            below = (pool is not None
                     and int(pool.alive.sum()) < serving.n_workers)
            entry = _GroupQueue(serving, replanned, deque(reqs),
                                width=self._wave_width(serving))
            (degraded if (replanned or below) else healthy).append(entry)
        if healthy and degraded:
            self.stats["deferred_groups"] += len(degraded)
        self._serve_phase(healthy, results)
        self._serve_phase(degraded, results)
        return results

    def _wave_width(self, proto: AGECMPCProtocol) -> int:
        """Lanes per wave for one group: :func:`wave_width` under this
        engine's knobs."""
        return wave_width(proto.spec, max_batch=self.max_batch,
                          wave_scalars=self.wave_scalars,
                          inflight=self.inflight)

    def _timed(self, proto: AGECMPCProtocol, phase: str, scalars: int,
               lanes: int, fn):
        """Run ``fn()``; with a recorder, synchronise and record its wall
        time (device −1: one wave runs all N logical workers)."""
        if self.recorder is None:
            return fn()
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            # analysis: allow(host-sync): only with a recorder, to time the stage
            torch.cuda.synchronize(self.device)
        self.recorder.record(device=-1, klass=proto.spec.scheme, phase=phase,
                             scalars=scalars,
                             us=(time.perf_counter() - t0) * 1e6,
                             lanes=lanes)
        return out

    def _serve_phase(self, entries: List[_GroupQueue],
                     results: Dict[int, torch.Tensor]) -> None:
        """Round-robin the phase's groups, one wave per turn (FIFO within
        a group)."""
        rr = deque(entries)
        while rr:
            g = rr.popleft()
            width = g.width
            take = _next_wave(len(g.queue), width)
            reqs = [g.queue.popleft() for _ in range(take)]
            self.stats["waves"] += 1
            if take == 1 and width == 1 and not g.proto.spec.adversaries:
                self._serve_single(g.proto, g.replanned, reqs[0], results)
            else:
                self._flush_wave(g.proto, g.replanned, reqs, results)
            if g.queue:
                rr.append(g)

    def _serve_single(self, proto: AGECMPCProtocol, replanned: bool,
                      req: MPCRequest,
                      results: Dict[int, torch.Tensor]) -> None:
        """Width-1 path: the plan's fused single-request stages.  Mask
        semantics match the wave path exactly."""
        n = proto.n_workers
        pool = self._pools.get(proto.group_key)
        mask = (pool.alive[:n].copy() if pool is not None
                else np.ones(n, bool))
        if req.survivors is not None:
            if replanned:
                # sized for the pre-replan worker set: no longer valid
                self.stats["masks_dropped"] += 1
            else:
                mask &= req.survivors
        try:
            surv = None if mask.all() else mask
            results[req.rid] = self._timed(
                proto, "fused", request_scalars(proto.spec), 1,
                lambda: proto.run(req.a, req.b, req.key, survivors=surv,
                                  device=self.device))
        except RuntimeError as e:
            self._fail_request(req, str(e))

    def _flush_wave(self, proto: AGECMPCProtocol, replanned: bool,
                    reqs: List[MPCRequest],
                    results: Dict[int, torch.Tensor]) -> None:
        plan = proto.plan
        dev = self.device
        n = proto.n_workers
        spec = proto.spec
        # pool attrition among the first N folds into every request's mask
        pool = self._pools.get(proto.group_key)
        pool_mask = (pool.alive[:n] if pool is not None
                     else np.ones(n, bool))
        # pad to a power of two with repeats of the last request, as the
        # reference does (the padded lanes are computed and discarded)
        width = _pad_pow2(len(reqs), self.max_batch)
        pad = width - len(reqs)
        self.stats["padded_lanes"] += pad
        lanes = reqs + [reqs[-1]] * pad
        a = torch.stack([r.a for r in lanes])
        b = torch.stack([r.b for r in lanes])
        keys = [r.key for r in lanes]
        vfront = plan.batched("vfront", dev)
        i_pts = self._timed(proto, "front", width * request_scalars(spec),
                            width, lambda: vfront(a, b, keys))
        self.stats["batches"] += 1

        # verified groups: tag every share in one launch, corrupt through
        # the injector (if any), tag again and compare; the honesty mask
        # finds liars before decode runs
        budget = spec.adversaries
        honest_b: Optional[np.ndarray] = None
        if budget:
            params = [byz.mac_params(plan, r.key, dev) for r in lanes]
            gammas = torch.stack([pr[0] for pr in params])
            offs = torch.stack([pr[1] for pr in params])
            rvecs = torch.stack([pr[2] for pr in params])
            vtags = plan.batched("vtags", dev)
            tags_b = vtags(i_pts, gammas, offs, rvecs)          # [B, N]
            if self.injector is not None:
                # the test harness: corrupt each request's shares on the
                # device (a tampered slot's delta is the only upload)
                for pos, req in enumerate(reqs):
                    pts, tgs = i_pts[pos], tags_b[pos]
                    pts_c, tags_c = self.injector.corrupt(plan, pts, tgs,
                                                          req.rid)
                    if pts_c is not pts:      # decode serves what was sent
                        pts.copy_(pts_c)
                        tgs.copy_(tags_c)
            # analysis: allow(host-sync): the honesty mask drives control flow
            honest_b = torch.eq(vtags(i_pts, gammas, offs, rvecs),
                                tags_b).cpu().numpy()            # [B, N]

        # sub-group by survivor prefix; one vdecode launch per pattern
        patterns: "OrderedDict[tuple, List[int]]" = OrderedDict()
        for pos, req in enumerate(reqs):
            mask = pool_mask.copy()
            if req.survivors is not None:
                if replanned:
                    # sized for the pre-replan worker set: no longer valid
                    self.stats["masks_dropped"] += 1
                else:
                    mask &= req.survivors
            try:
                if honest_b is None:
                    idx = spec.validate_survivors(mask)
                else:
                    liars = np.nonzero(mask & ~honest_b[pos])[0]
                    if len(liars) > budget:
                        raise AdversaryBudgetError(
                            f"adversary budget exhausted: {len(liars)} "
                            f"corrupted shares detected > budget "
                            f"a={budget}", spec=spec, quorum=budget,
                            alive=int(mask.sum()), slots=liars)
                    if len(liars):
                        self.stats["corrections"] += len(liars)
                        self._evict_liars(proto, liars)
                        mask = mask & honest_b[pos]
                    # MACs vouched for the survivors: the plain t²+z decodes
                    idx = spec.validate_survivors(mask, corrected=True)
            except RuntimeError as e:
                # this request fails alone; the rest of the wave is served
                self._fail_request(req, str(e))
                continue
            patterns.setdefault(tuple(int(i) for i in idx), []).append(pos)
        vdecode = plan.batched("vdecode", dev)
        mt2 = (spec.m // spec.t) ** 2
        for idx, positions in patterns.items():
            idx_t, rows_t = plan.survivor_tables(idx, dev)
            sel = (None if positions == list(range(width)) else
                   torch.tensor(positions, dtype=torch.int64, device=dev))
            ys = self._timed(
                proto, "decode", len(positions) * len(idx) * mt2,
                len(positions),
                lambda sel=sel: vdecode(i_pts, idx_t, rows_t, sel))
            for k, pos in enumerate(positions):
                results[reqs[pos].rid] = ys[k]
