"""Execution backends for :class:`repro_torch.mpc.api.MPCSession`.

Port of ``repro/mpc/backends.py``.  A backend runs a list of coded block
products (``BlockOp``: protocol + field-domain ``m×m`` operands + key +
survivor mask) and returns one field-domain result, or a ``BlockFailure``,
per op, in order.  A block the backend cannot serve (mask below the
quorum, infeasible pool, adversary budget exhausted) becomes a
``BlockFailure`` in its slot and never takes down the other blocks.

* :class:`LocalBackend`: every block through ``AGECMPCProtocol.run`` on
  the session's device; with an adversary budget, through
  ``run_verified`` (and an optional :class:`FaultInjector`).
* :class:`BatchedBackend`: the whole op list submitted to an
  :class:`~repro_torch.mpc.engine.MPCEngine` and served in ONE flush;
  session attrition routes into the engine's elastic pools.
* :class:`RemoteBackend`: the N workers behind the framed socket
  transport (:mod:`repro_torch.transport`), loopback threads or spawned
  processes, computing on the session's device.

* :class:`ShardedBackend`: every block through a
  :class:`~repro_torch.mpc.secure_matmul.ShardedCMPC` runner (one per
  plan) over a mesh axis, decoded on the mesh's first device.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Union

from .. import spans
from .api import BlockFailure, BlockOp
from .errors import QuorumError
from .field import resolve_device
from .protocol import MODES

BlockResult = Union[Any, BlockFailure]  # a field-domain tensor, or a failure

_UNSET = object()  # "keep the engine's default" sentinel for wave knobs


class MPCBackend:
    """Backend interface: run blocks, optionally own attrition handling."""

    name = "abstract"
    # True when the backend tracks dead workers itself (elastic pools);
    # otherwise the session folds its dead set into each block's mask
    handles_attrition = False

    def run_blocks(self, ops: Sequence[BlockOp]) -> List[BlockResult]:
        raise NotImplementedError

    def fail(self, dead: frozenset) -> None:
        """Receive the session's cumulative dead-worker set (ids)."""

    def dispatch_scale(self, spec) -> float:
        """How much costlier one block dispatch is here than the host
        baseline (scales the cost model's ``dispatch`` term in the
        session's block search): 1.0 unless the backend serializes."""
        return 1.0

    def drain_spec(self, spec, shape, *, batch: int = 1, cost=None,
                   tile_budget=None):
        """A free re-tune for queued, not yet tiled work after attrition,
        or ``None``; only backends with pool machinery answer."""
        return None

    def byzantine_stats(self) -> Dict[str, int]:
        """Cumulative verified-decode counters: shares corrected out of a
        decode and distinct workers evicted as liars."""
        return {"corrections": 0, "evicted_devices": 0}

    def scheduler_stats(self) -> Dict[str, int]:
        """Cumulative wave-admission counters (waves, padded lanes,
        deferred groups); zeros without wave machinery."""
        return {"waves": 0, "padded_lanes": 0, "deferred_groups": 0}

    def take_new_liars(self) -> set:
        """Drain liar ids caught since the last call: roster device ids
        for pool specs, protocol slots otherwise."""
        return set()


class LocalBackend(MPCBackend):
    """Single-process execution, one ``run`` per block (``mode`` =
    ``"fused"`` | ``"kernel"`` | ``"reference"``).

    Blocks whose spec carries an adversary budget go through
    ``AGECMPCProtocol.run_verified``, with ``injector`` (a
    :class:`~repro_torch.mpc.byzantine.FaultInjector`) corrupting shares
    between the worker phase and the MAC check, its round counter one per
    verified block.  Caught liars surface through :meth:`byzantine_stats`
    and :meth:`take_new_liars` in roster device ids (slots without a
    pool)."""

    name = "local"

    def __init__(self, *, mode: str = "fused", injector=None):
        if mode not in MODES:
            raise ValueError(
                f"unknown mode {mode!r}: expected fused|kernel|reference")
        self.mode = mode
        self.injector = injector
        self._round = 0
        self._corrections = 0
        self._evicted: set = set()
        self._new_liars: set = set()

    def byzantine_stats(self) -> Dict[str, int]:
        return {"corrections": self._corrections,
                "evicted_devices": len(self._evicted)}

    def take_new_liars(self) -> set:
        out, self._new_liars = self._new_liars, set()
        return out

    def _run_verified(self, op: BlockOp):
        rnd, self._round = self._round, self._round + 1
        y, verdict = op.proto.run_verified(
            op.a, op.b, op.key, survivors=op.survivors,
            injector=self.injector, round_id=rnd)
        if verdict.liars:
            self._corrections += verdict.corrected
            placement = op.proto.spec.effective_placement
            devs = {int(s) if placement is None else int(placement[s])
                    for s in verdict.liars}
            self._new_liars |= devs - self._evicted
            self._evicted |= devs
        return y

    def run_blocks(self, ops: Sequence[BlockOp]) -> List[BlockResult]:
        outs: List[BlockResult] = []
        for i, op in enumerate(ops):
            with spans.span("mpc.block", index=i):
                try:
                    if op.proto.adversaries:
                        outs.append(self._run_verified(op))
                    else:
                        outs.append(op.proto.run(op.a, op.b, op.key,
                                                 survivors=op.survivors,
                                                 mode=self.mode))
                except QuorumError as e:  # below quorum or budget: isolate
                    outs.append(BlockFailure(str(e)))
        return outs


class BatchedBackend(MPCBackend):
    """Engine-backed execution: one ``MPCEngine`` flush per op list.

    Options go to the engine it builds (``spares``, ``max_batch``,
    ``cost``, ``injector``, ``wave_scalars``, ``inflight``, ``recorder``,
    ``device``), or onto a given ``engine``."""

    name = "batched"
    handles_attrition = True

    def __init__(self, *, spares: int = 2, max_batch: int = 64, engine=None,
                 cost=None, injector=None, wave_scalars=_UNSET,
                 inflight=None, recorder=None, device=None):
        from .engine import MPCEngine

        if engine is None:
            kw = {} if wave_scalars is _UNSET else dict(
                wave_scalars=wave_scalars)
            engine = MPCEngine(spares=spares, max_batch=max_batch,
                               cost=cost, injector=injector,
                               inflight=inflight, recorder=recorder,
                               device=device, **kw)
        else:
            if injector is not None:
                engine.injector = injector
            if wave_scalars is not _UNSET:
                engine.wave_scalars = wave_scalars
            if inflight is not None:
                engine.inflight = inflight
            if recorder is not None:
                engine.recorder = recorder
        self.engine = engine
        self._dead: frozenset = frozenset()

    def fail(self, dead: frozenset) -> None:
        self._dead = frozenset(dead)

    def byzantine_stats(self) -> Dict[str, int]:
        return self.engine.byzantine_stats()

    def scheduler_stats(self) -> Dict[str, int]:
        s = self.engine.stats
        return {"waves": s["waves"], "padded_lanes": s["padded_lanes"],
                "deferred_groups": s["deferred_groups"]}

    def take_new_liars(self) -> set:
        return self.engine.take_new_liars()

    def _report_attrition(self, proto) -> None:
        if not self._dead:
            return
        pool = self.engine.pool(spec=proto.spec)
        if pool.device_map is not None:  # pool spec: ids are device ids
            pool.fail_devices(sorted(self._dead))
            return
        ids = [w for w in sorted(self._dead) if w < pool.pool_size]
        if ids:
            pool.fail(ids)

    def drain_spec(self, spec, shape, *, batch: int = 1, cost=None,
                   tile_budget=None):
        """Answer the session's drain question through the engine's pools
        (attrition is reported first, so a drain can engage before the
        first flush after a failure reaches the engine)."""
        if spec.m is None or not self._dead:
            return None
        from .protocol import AGECMPCProtocol

        self._report_attrition(AGECMPCProtocol.from_spec(spec))
        return self.engine.drain_spec(spec, shape, batch=batch, cost=cost,
                                      tile_budget=tile_budget)

    def run_blocks(self, ops: Sequence[BlockOp]) -> List[BlockResult]:
        if not ops:  # never flush a (possibly shared) engine for nothing
            return []
        if self._dead:  # once per distinct serving group, not per block
            seen = set()
            for op in ops:
                if op.proto.group_key not in seen:
                    seen.add(op.proto.group_key)
                    self._report_attrition(op.proto)
        rids = []
        for op in ops:
            try:
                rids.append(self.engine.submit(
                    op.a, op.b, key=op.key, survivors=op.survivors,
                    spec=op.proto.spec))
            except QuorumError as e:  # submit-time mask validation
                rids.append(BlockFailure(str(e)))
        results = self.engine.flush()
        outs: List[BlockResult] = []
        for rid in rids:
            if isinstance(rid, BlockFailure):
                outs.append(rid)
            elif rid in results:
                outs.append(results[rid])
            else:
                outs.append(BlockFailure(
                    self.engine.failures.get(rid, "request not served")))
        return outs


class RemoteBackend(MPCBackend):
    """Out-of-process execution over the worker transport.

    Each serving group's N workers run behind a
    :class:`~repro_torch.transport.dealer.Dealer`: loopback worker threads
    by default (``spawn="thread"``, sharing the process-wide plan cache),
    spawned processes with ``spawn="process"``.  Blocks are served by the
    pipelined protocol driver (:func:`repro_torch.transport.driver
    .run_blocks`; ``pipelined=False`` keeps the phase-barriered baseline).
    Dealer and workers compute on ``device`` (the session's): the workers
    run the same stages, on plan tables they rebuild deterministically, so
    decode is integer-equal to the local backend.

    Failure semantics: a worker death before its phase-2 G row lands is a
    phase-2 loss: the driver reports the dead slots, the backend routes
    them through ``engine.fail`` (→ ``ElasticPool.fail_devices`` for pool
    specs) and re-dispatches the lost blocks under the engine's
    retune-before-replan escalation, exactly like in-process serving.
    ``spares=0`` (the default here) makes ANY death escalate
    deterministically: the transport cannot serve the in-process
    spare-quorum path.  A death after the G row is a phase-3 loss the
    survivor mask absorbs.

    ``recorder`` (e.g. :class:`repro_torch.sim.trace.PhaseRecorder`)
    receives measured per-device ``compute``/``exchange`` wire samples,
    feeding ``sim.calibrate`` / ``CostModel.from_bench`` with real ζ time.
    ``dealer_us`` sums the driver's ``dealer_us`` (the dealer's time
    outside its wait for replies) over every flush.
    """

    name = "remote"
    handles_attrition = True

    #: phase-2 loss → fail → retune/replan → re-dispatch rounds before a
    #: block gives up (escalation chains are short; 8 is generous)
    MAX_ROUNDS = 8

    def __init__(self, *, spawn: str = "thread", spares: int = 0,
                 pipelined: bool = True, window: int = None,
                 deadline_s: float = None, retries: int = None,
                 backoff: float = None, delay_s: float = 0.0, cost=None,
                 recorder=None, engine=None, device=None):
        from .engine import MPCEngine

        if engine is None:
            engine = MPCEngine(spares=spares, cost=cost, recorder=recorder,
                               device=device)
        self.engine = engine
        self.device = engine.device if device is None else resolve_device(
            device)
        self.spawn = spawn
        self.pipelined = pipelined
        self.delay_s = float(delay_s)  # simulated link RTT (benchmarks)
        self.recorder = recorder
        self._driver_kw = {
            k: v for k, v in (("window", window), ("deadline_s", deadline_s),
                              ("retries", retries), ("backoff", backoff))
            if v is not None}
        self._dealers: Dict[tuple, object] = {}
        self._dead: frozenset = frozenset()
        self.stats = {"blocks": 0, "phase_losses": 0, "redispatches": 0,
                      "masks_dropped": 0, "retries": 0, "evictions": 0,
                      "phase3_absorbed": 0}
        self.dealer_us = 0.0

    # -------------------------------------------------------------- dealers
    def _dealer(self, serving):
        from ..transport.dealer import Dealer

        key = serving.group_key
        d = self._dealers.get(key)
        if d is None:
            d = self._dealers[key] = Dealer(serving, spawn=self.spawn,
                                            delay_s=self.delay_s,
                                            device=self.device)
        return d

    def _drop_dealer(self, key) -> None:
        d = self._dealers.pop(key, None)
        if d is not None:
            d.close()

    def close(self) -> None:
        """Stop every spawned worker and close the links."""
        for d in list(self._dealers.values()):
            d.close()
        self._dealers.clear()

    def chaos(self, proto, device: int, **doc) -> None:
        """Script a fault into one live worker of ``proto``'s serving
        group (test hook; see :class:`repro_torch.transport.worker._Chaos`
        and ``byzantine.FaultInjector.to_json`` for the shared schedule
        format)."""
        serving = self.engine.serving_proto(proto)
        self._dealer(serving).chaos(int(device), **doc)

    # ------------------------------------------------------------ attrition
    def fail(self, dead: frozenset) -> None:
        self._dead = frozenset(dead)

    def _report_attrition(self, proto) -> None:
        if not self._dead:
            return
        pool = self.engine.pool(spec=proto.spec)
        if pool.device_map is not None:  # pool spec: ids are device ids
            pool.fail_devices(sorted(self._dead))
            return
        ids = [w for w in sorted(self._dead) if w < pool.pool_size]
        if ids:
            pool.fail(ids)

    def drain_spec(self, spec, shape, *, batch: int = 1, cost=None,
                   tile_budget=None):
        if spec.m is None or not self._dead:
            return None
        from .protocol import AGECMPCProtocol

        self._report_attrition(AGECMPCProtocol.from_spec(spec))
        return self.engine.drain_spec(spec, shape, batch=batch, cost=cost,
                                      tile_budget=tile_budget)

    # --------------------------------------------------------------- blocks
    def run_blocks(self, ops: Sequence[BlockOp]) -> List[BlockResult]:
        import dataclasses

        import numpy as np

        from ..transport import driver as _driver
        from ..transport.dealer import WorkerDown, slot_devices

        if not ops:
            return []
        if self._dead:  # once per distinct serving group, not per block
            seen = set()
            for op in ops:
                if op.proto.group_key not in seen:
                    seen.add(op.proto.group_key)
                    self._report_attrition(op.proto)
        results: List[BlockResult] = [None] * len(ops)
        pending = list(enumerate(ops))
        for _ in range(self.MAX_ROUNDS):
            if not pending:
                break
            groups: Dict[tuple, list] = {}
            order: List[tuple] = []
            for pos, op in pending:
                try:
                    serving = self.engine.serving_proto(op.proto)
                except RuntimeError as e:  # infeasible pool: fail alone
                    results[pos] = BlockFailure(str(e))
                    continue
                key = serving.group_key
                if key not in groups:
                    groups[key] = [serving]
                    order.append(key)
                groups[key].append((pos, op))
            pending = []
            for key in order:
                serving, *items = groups[key]
                n = serving.n_workers
                pool = self.engine._pools.get(key)
                pool_mask = (pool.alive[:n].copy() if pool is not None
                             else np.ones(n, bool))
                driver_ops = []
                for pos, op in items:
                    if op.proto.group_key != key:  # escalated away
                        self._drop_dealer(op.proto.group_key)
                    surv = op.survivors
                    if surv is not None and op.proto.group_key != key:
                        # sized for the pre-replan worker set: invalid now
                        surv = None
                        self.stats["masks_dropped"] += 1
                    mask = pool_mask.copy()
                    if surv is not None:
                        # analysis: allow(host-sync): survivor masks are host data
                        mask &= np.asarray(surv, bool)
                    driver_ops.append(dataclasses.replace(
                        op, proto=serving,
                        survivors=None if mask.all() else mask))
                try:
                    dealer = self._dealer(serving)
                except WorkerDown as e:  # group failed to come up
                    self._drop_dealer(key)
                    for pos, op in items:
                        results[pos] = BlockFailure(str(e))
                    continue
                outcomes, dstats = _driver.run_blocks(
                    dealer, driver_ops, pipelined=self.pipelined,
                    recorder=self.recorder, **self._driver_kw)
                for k in ("retries", "evictions", "phase3_absorbed"):
                    self.stats[k] += dstats[k]
                self.dealer_us += dstats["dealer_us"]
                lost_devices: set = set()
                for (pos, op), out in zip(items, outcomes, strict=True):
                    if isinstance(out, _driver.PhaseLoss):
                        lost_devices.update(
                            slot_devices(serving.spec, out.slots))
                        self.stats["phase_losses"] += 1
                        pending.append((pos, op))
                    elif isinstance(out, _driver.BlockError):
                        results[pos] = BlockFailure(out.reason)
                    else:
                        results[pos] = out
                        self.stats["blocks"] += 1
                if lost_devices:
                    # the in-process escalation path, verbatim: fail →
                    # retune (m fixed) → replan; next round re-dispatches
                    self.engine.fail(sorted(lost_devices),
                                     spec=serving.spec)
                    self._drop_dealer(key)
                    self.stats["redispatches"] += 1
        for pos, op in pending:
            results[pos] = BlockFailure(
                f"remote re-dispatch did not converge in "
                f"{self.MAX_ROUNDS} rounds")
        return results


class ShardedBackend(MPCBackend):
    """Mesh-axis execution through ``ShardedCMPC`` (one runner per plan).

    ``mesh`` (a :class:`~repro_torch.parallel.compat.Mesh`), ``axis``,
    ``wire_dtype`` (``"int64"`` or ``"int32"``) and ``prg_masks`` go to the
    runners.  A block whose survivor mask is below the quorum becomes a
    ``BlockFailure``; a kernel or device error propagates."""

    name = "sharded"

    def __init__(self, *, mesh=None, axis: str = "model",
                 wire_dtype: str = "int64", prg_masks: bool = False):
        if mesh is None:
            raise ValueError("the sharded backend requires mesh=...")
        self.mesh = mesh
        self.axis = axis
        self.wire_dtype = wire_dtype
        self.prg_masks = prg_masks
        self._runners: Dict[tuple, object] = {}

    def dispatch_scale(self, spec) -> float:
        """Mesh-shape-aware dispatch weight: N logical workers pack onto
        the ``axis``-sized mesh, so every per-block program runs its worker
        phases in ``ceil(N / axis_size)`` serialized waves, and the block
        search coarsens sooner here than on the local backend."""
        from .workers import dispatch_waves

        return float(dispatch_waves(spec.n_workers,
                                    self.mesh.shape[self.axis]))

    def _runner(self, proto):
        from .secure_matmul import ShardedCMPC

        key = proto.plan_key
        sh = self._runners.get(key)
        if sh is None:
            sh = self._runners[key] = ShardedCMPC(
                proto, self.mesh, self.axis, wire_dtype=self.wire_dtype,
                prg_masks=self.prg_masks)
        return sh

    def run_blocks(self, ops: Sequence[BlockOp]) -> List[BlockResult]:
        outs: List[BlockResult] = []
        for op in ops:
            try:
                outs.append(self._runner(op.proto).run(
                    op.a, op.b, op.key, survivors=op.survivors))
            except QuorumError as e:  # below quorum: isolate the block
                outs.append(BlockFailure(str(e)))
        return outs


BACKENDS = {"local": LocalBackend, "batched": BatchedBackend,
            "remote": RemoteBackend, "sharded": ShardedBackend}


def resolve_backend(backend: Union[str, MPCBackend],
                    **opts) -> MPCBackend:
    """A backend instance from a name (+ options) or a ready instance."""
    if isinstance(backend, MPCBackend):
        if opts:
            raise ValueError(
                f"backend options {sorted(opts)} ignored for an instance")
        return backend
    try:
        cls = BACKENDS[backend]
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}: expected one of "
            f"{sorted(BACKENDS)} or an MPCBackend instance") from None
    return cls(**opts)
