"""The MPC surface on torch: ``MPCSpec`` + ``MPCSession`` + ``connect``.

Port of ``repro/mpc/api.py``::

    spec = MPCSpec(s=2, t=2, z=2)
    sess = connect(spec)                      # runs on the card
    y = sess.matmul(a, b)                     # floats in, floats out

* :class:`MPCSpec` — scheme, partitioning, collusion bound, gap, field and
  fixed-point config in one frozen, validated, hashable object: the single
  source of plan keys, plan resolution, protocol construction and
  survivor-mask validation.
* :class:`MPCSession` — ``matmul(a, b)``, ``submit``/``flush``,
  ``fail(workers)``, ``validate_survivors(mask)``.  Operands may be
  rectangular ``[r,k]×[k,c]`` with leading batch dimensions; the shape
  adapter (:mod:`repro_torch.mpc.tiling`) maps them onto the coded ``m×m``
  block grid, the backend runs the blocks, and the session folds the field
  encode/decode in so callers pass floats end to end.
* :func:`connect` — a session on a backend and a device.  The device is
  the card unless the caller passes ``device="cpu"``; with no card and no
  device it raises.

Key discipline: ``key`` is an int seed or a ``torch.Generator`` on the
session's device.  A call that maps to a single coded block consumes the
key directly (identical to ``AGECMPCProtocol.run``); a multi-block call
derives a per-block seed from (base key, block index) so every block draws
distinct phase-1/2 randomness.  ``Y`` does not depend on the draws: the
masks cancel.

Heterogeneous worker pools and placements (:mod:`.workers`),
``MPCSpec.tune`` and cost-model block search (:mod:`.autotune`), and
adversary budgets with MAC-verified decode (:mod:`.byzantine`) work as in
the reference, on the ``local`` and ``batched`` backends; the ``remote``
backend (the socket transport) and the ``sharded`` backend (the runner
over a mesh axis, :mod:`.secure_matmul`) serve plain specs, as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import spans
from .errors import MaskShapeError, QuorumError
from .field import DEFAULT_FIELD, Field, fold_in, resolve_device
from .planner import PlanKey, ProtocolPlan, _resolve_code, get_plan
from .tiling import (
    DEFAULT_TILE_BUDGET,
    TileMap,
    assemble,
    choose_block,
    choose_block_cost,
    tile_blocks,
)
from .workers import WorkerPool

SCHEMES = ("age", "entangled", "polydot")


# ===================================================================== spec
@dataclasses.dataclass(frozen=True)
class MPCSpec:
    """Frozen, validated protocol parameterization.

    Parameters
    ----------
    s, t : matrix partitions (the paper's s×t block grid)
    z    : collusion bound
    lam  : AGE gap; ``None`` solves ``min_λ`` (eq. (13))
    scheme : "age" | "entangled" | "polydot"
    field  : prime field + fixed-point encoding config (``Field.frac_bits``)
    m      : optional default protocol block side (``s|m`` and ``t|m``);
             unset, the session's shape adapter picks one per workload
    pool   : optional heterogeneous device roster (:class:`WorkerPool`).
             With a pool, worker ids given to ``fail`` are roster *device*
             ids, translated to protocol slots through the placement;
             survivor masks stay slot-indexed (``[N]`` bools).
    placement : optional roster device id serving each protocol slot
             ``0..N-1`` (distinct, in range); ``None`` with a pool is the
             identity prefix
    adversaries : Byzantine budget ``a`` >= 0: how many workers may return
             wrong shares per round.  ``a > 0`` raises the serving quorum
             to ``t²+z + 2a`` and routes every decode through MAC
             verification; the code's worker count must cover it.
    """

    s: int
    t: int
    z: int
    lam: Optional[int] = None
    scheme: str = "age"
    field: Field = DEFAULT_FIELD
    m: Optional[int] = None
    pool: Optional[WorkerPool] = None
    placement: Optional[Tuple[int, ...]] = None
    adversaries: int = 0

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(
                f"unknown scheme {self.scheme!r}: expected one of {SCHEMES}")
        for name in ("s", "t", "z"):
            v = getattr(self, name)
            if not isinstance(v, (int, np.integer)) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        if self.lam is not None and self.lam < 0:
            raise ValueError(f"lam must be None or >= 0, got {self.lam!r}")
        if not isinstance(self.field, Field):
            raise TypeError(f"field must be a Field, got {self.field!r}")
        if self.m is not None and (self.m < 1 or self.m % self.s
                                   or self.m % self.t):
            raise ValueError(
                f"need s|m and t|m: s={self.s} t={self.t} m={self.m}")
        if self.pool is not None and not isinstance(self.pool, WorkerPool):
            raise TypeError(f"pool must be a WorkerPool, got {self.pool!r}")
        if self.placement is not None:
            if self.pool is None:
                raise ValueError("placement requires a pool")
            pl = tuple(int(d) for d in self.placement)
            if len(set(pl)) != len(pl) or any(
                    not 0 <= d < len(self.pool) for d in pl):
                raise ValueError(
                    f"placement must be distinct device ids within the "
                    f"{len(self.pool)}-device pool, got {self.placement!r}")
            object.__setattr__(self, "placement", pl)
        a = self.adversaries
        if isinstance(a, bool) or not isinstance(a, (int, np.integer)) or a < 0:
            raise ValueError(f"adversaries must be an int >= 0, got {a!r}")
        if a > 0 and self.n_workers < self.verified_threshold:
            raise ValueError(
                f"adversary budget a={a} needs N >= t²+z+2a = "
                f"{self.verified_threshold} workers but the "
                f"{self.scheme} code provides only N={self.n_workers}")

    # ------------------------------------------------------------ identity
    def replace(self, **kw) -> "MPCSpec":
        """A copy with the given fields replaced (validated again)."""
        return dataclasses.replace(self, **kw)

    def plan_key(self, m: Optional[int] = None) -> PlanKey:
        """The process-wide planner-cache key for this spec (+ block side).

        Pool-free specs keep the 7-tuple; a pool appends the effective
        placement (it never changes the plan's tables: the qualified key
        aliases the shared plan)."""
        base = (self.scheme, self.s, self.t, self.z, self.lam,
                self.field.p, self._block(m))
        if self.pool is None:
            return base
        return base + (self.effective_placement,)

    @property
    def pool_key(self) -> Optional[Tuple]:
        """Hashable roster signature, or ``None`` without a pool."""
        return None if self.pool is None else self.pool.key

    def group_key(self, m: Optional[int] = None) -> Tuple:
        """Serving-group identity: ``plan_key``, extended with the pool
        signature for pool specs and with ``("byz", a)`` for a nonzero
        adversary budget (verified and unverified requests never share a
        serving group)."""
        pk = self.plan_key(m)
        if self.pool is not None:
            pk = pk + (self.pool.key,)
        if self.adversaries:
            pk = pk + (("byz", self.adversaries),)
        return pk

    @property
    def effective_placement(self) -> Optional[Tuple[int, ...]]:
        """The placement in force: ``None`` without a pool, the explicit
        placement when set (checked against N), else the identity prefix."""
        if self.pool is None:
            return None
        n = self.n_workers
        if self.placement is not None:
            if len(self.placement) != n:
                raise ValueError(
                    f"placement has {len(self.placement)} devices but the "
                    f"code needs N={n} workers")
            return self.placement
        if len(self.pool) < n:
            raise ValueError(
                f"pool has {len(self.pool)} devices < N={n}")
        return tuple(range(n))

    def slots_for(self, devices) -> Tuple[int, ...]:
        """Translate worker ids to protocol slots: without a pool ids are
        slots; with one they are roster device ids, and devices outside
        the placement have no slot and are dropped."""
        pl = self.effective_placement
        if pl is None:
            return tuple(sorted(int(d) for d in devices))
        inv = {d: i for i, d in enumerate(pl)}
        return tuple(sorted(inv[int(d)] for d in devices if int(d) in inv))

    def _block(self, m: Optional[int]) -> int:
        m = self.m if m is None else m
        if m is None:
            raise ValueError(
                "no block size: pass m or construct the spec with one")
        return int(m)

    # ------------------------------------------------------- derived facts
    @property
    def code(self):
        """The degree-set code (memoized; independent of the block side)."""
        return _resolve_code(self.scheme, self.s, self.t, self.z, self.lam)

    @property
    def n_workers(self) -> int:
        return self.code.n_workers

    @property
    def recovery_threshold(self) -> int:
        return self.t * self.t + self.z

    @property
    def verified_threshold(self) -> int:
        """Alive workers a verified decode needs: ``t²+z + 2a`` (the plain
        recovery threshold when ``a = 0``)."""
        return self.recovery_threshold + 2 * self.adversaries

    @property
    def frac_bits(self) -> int:
        return self.field.frac_bits

    # ----------------------------------------------------------- factories
    @classmethod
    def tune(cls, n_workers: Optional[int] = None, z: int = None,
             shape=None, **kw) -> "MPCSpec":
        """The autotuned spec for a worker budget and a workload ``shape =
        (r, k, c)``: :func:`repro_torch.mpc.autotune.tune`'s winner, with
        its block side (and, with ``pool=``, its placement) baked in."""
        from .autotune import tune as _tune

        return _tune(n_workers, z, shape, **kw).spec

    def plan(self, m: Optional[int] = None) -> ProtocolPlan:
        """The cached data-independent tables for this spec at block ``m``."""
        return get_plan(self.scheme, self.s, self.t, self.z, self.lam,
                        self.field, self._block(m),
                        placement=self.effective_placement)

    def protocol(self, m: Optional[int] = None):
        """An :class:`~repro_torch.mpc.protocol.AGECMPCProtocol` for
        block ``m``."""
        from .protocol import AGECMPCProtocol

        return AGECMPCProtocol.from_spec(self, m=m)

    # ------------------------------------------------- survivor validation
    def validate_survivors(self, survivors, *,
                           corrected: bool = False) -> np.ndarray:
        """First ``t²+z`` alive worker indices for a survivor mask.

        Raises :class:`~repro_torch.mpc.errors.MaskShapeError` (a
        ``ValueError``) on a mis-shaped mask and
        :class:`~repro_torch.mpc.errors.QuorumError` (a ``RuntimeError``)
        when fewer survive than the quorum: ``t²+z``, or the verified
        ``t²+z + 2a`` when ``adversaries > 0``.  ``corrected=True`` marks a
        mask already through MAC verification (liars excluded): only the
        plain ``t²+z`` applies.  The returned prefix is always the ``t²+z``
        decode quorum; its frozen tuple keys the plan's survivor LRU.
        """
        t2z = self.recovery_threshold
        need = t2z if corrected else self.verified_threshold
        n = self.n_workers
        alive = (np.ones(n, bool) if survivors is None
                 # analysis: allow(host-sync): survivor masks are host data
                 else np.asarray(survivors, bool))
        if alive.shape != (n,):
            raise MaskShapeError(
                f"survivors mask must have shape ({n},), got {alive.shape}",
                spec=self, quorum=need)
        idx = np.nonzero(alive)[0]
        if len(idx) < need:
            detail = ("" if need == t2z else
                      f" (verified quorum t²+z+2a for adversary budget "
                      f"a={self.adversaries})")
            raise QuorumError(
                f"only {len(idx)} workers alive < threshold {need}{detail}",
                spec=self, quorum=need, alive=len(idx),
                slots=np.nonzero(~alive)[0])
        return idx[:t2z]


# ================================================================== blocks
@dataclasses.dataclass(frozen=True)
class BlockOp:
    """One coded ``m×m`` block product ``Y = AᵀB`` for a backend to run."""

    proto: Any                       # AGECMPCProtocol
    a: torch.Tensor                  # [m, m] field elements (the Aᵀ operand)
    b: torch.Tensor                  # [m, m] field elements
    key: Any                         # int seed or torch.Generator
    survivors: Optional[np.ndarray]  # bool [N] or None


@dataclasses.dataclass(frozen=True)
class BlockFailure:
    """A block a backend could not serve (below threshold)."""

    reason: str


@dataclasses.dataclass
class _Request:
    """One logical session matmul: its block ops + how to reassemble.

    ``raw`` keeps the un-tiled call (operands, key, flags, and the logical
    ``shape``/``batch``) so a queued request can be tiled again when an
    attrition drain adopts a spec with another block side; ``None`` for
    zero-size requests."""

    rid: int
    ops: List[BlockOp]
    build: Callable[[List[torch.Tensor]], torch.Tensor]
    raw: Optional[Dict[str, Any]] = None


def _describe(sp, ops: List[BlockOp]) -> None:
    """Give the ``mpc.call`` span ``sp`` the blocks the call issues and
    their side (0 when it issues none); nothing is built with spans off."""
    if spans.enabled():
        sp.set(blocks=len(ops), m=ops[0].proto.plan.m if ops else 0)


# ================================================================= session
class MPCSession:
    """One verb set over a backend, on one device (obtain via
    :func:`connect`).

    * :meth:`matmul` — rectangular/batched float (or field) matmul;
    * :meth:`submit` / :meth:`flush` — queue many matmuls, serve together;
    * :meth:`fail` — report worker attrition (folded into later decodes;
      the batched backend escalates through its elastic pools);
    * :meth:`validate_survivors` — the spec's public mask validation.
    """

    def __init__(self, spec: MPCSpec, backend, *, device, key=None,
                 tile_budget: int = DEFAULT_TILE_BUDGET, cost=None):
        if not isinstance(spec, MPCSpec):
            raise TypeError(f"spec must be an MPCSpec, got {spec!r}")
        if (isinstance(tile_budget, bool)
                or not isinstance(tile_budget, (int, np.integer))
                or tile_budget < 1):
            raise ValueError(
                f"tile_budget must be a positive int, got {tile_budget!r}")
        self.spec = spec
        self.backend = backend
        self.device = resolve_device(device)
        self._root_key = 0 if key is None else key
        self._calls = 0
        self._dead: set = set()
        self._pending: List[_Request] = []
        self._next_rid = 0
        self._tile_budget = int(tile_budget)
        # optional CostModel: block sides come from the cost-model search
        # instead of the fixed-(s, t) doubling rule
        self._cost = cost
        self.failures: Dict[int, str] = {}
        self.stats = {"matmuls": 0, "blocks": 0, "flushes": 0,
                      "retiles": 0, "masks_dropped": 0,
                      "corrections": 0, "evicted_devices": 0,
                      "waves": 0, "padded_lanes": 0, "deferred_groups": 0}

    # ------------------------------------------------------------- helpers
    def validate_survivors(self, survivors) -> np.ndarray:
        """Public survivor-mask validation (see ``MPCSpec``)."""
        return self.spec.validate_survivors(survivors)

    def fail(self, workers) -> None:
        """Mark workers dead for every later matmul/flush.

        Ids are protocol slots without a pool and roster device ids with
        one.  The local backend folds the dead set into each decode's
        survivor mask; the batched backend reports it to its elastic pools,
        so spares and retune/replan escalation engage."""
        # analysis: allow(host-sync): worker ids are host data
        ids = np.atleast_1d(np.asarray(workers, np.int64))
        # analysis: allow(host-sync): a numpy array's ids, already on the host
        self._dead.update(int(w) for w in ids.tolist())
        self.backend.fail(frozenset(self._dead))

    def _absorb_byzantine(self) -> None:
        """After every dispatch round: mirror the backend's wave and
        verified-decode counters into :attr:`stats`, and route newly caught
        liars through :meth:`fail` (a liar is attrition; ids are roster
        device ids for pool specs, slots otherwise)."""
        s = self.backend.scheduler_stats()
        for k in ("waves", "padded_lanes", "deferred_groups"):
            self.stats[k] = int(s.get(k, 0))
        c = self.backend.byzantine_stats()
        self.stats["corrections"] = int(c.get("corrections", 0))
        self.stats["evicted_devices"] = int(c.get("evicted_devices", 0))
        liars = self.backend.take_new_liars()
        if liars:
            self.fail(sorted(liars))

    def _serve_ops(self, ops: List[BlockOp]) -> List[BlockOp]:
        """Fold session attrition into each block's decode mask."""
        if self.backend.handles_attrition or not self._dead:
            return ops
        alive = np.ones(self.spec.n_workers, bool)
        for w in self.spec.slots_for(self._dead):
            if w < alive.size:
                alive[w] = False
        return [dataclasses.replace(
            op, survivors=(alive if op.survivors is None
                           # analysis: allow(host-sync): survivor masks are host data
                           else alive & np.asarray(op.survivors, bool)))
            for op in ops]

    def _next_key(self, key):
        if key is not None:
            return key
        return fold_in(self._root_key, self._calls)

    # -------------------------------------------------------- one matmul
    def matmul(self, a, b, *, key=None, survivors: Optional[np.ndarray] = None,
               encoded: bool = False, m: Optional[int] = None):
        """``a @ b`` under MPC, any ``[..., r, k] × [..., k, c]`` shapes.

        Floats go through the spec field's fixed-point encode/decode; pass
        ``encoded=True`` to treat operands as field elements and get the
        exact ``(a @ b) mod p`` back.  ``survivors`` is a bool ``[N]``
        decode mask applied to every block; ``m`` overrides the block side.
        Returns a tensor on the session's device.
        """
        with spans.span("mpc.call") as sp:
            req = self._build_request(a, b, key=key, survivors=survivors,
                                      encoded=encoded, m=m)
            _describe(sp, req.ops)
            outs = []
            if req.ops:
                outs = self.backend.run_blocks(self._serve_ops(req.ops))
                self.stats["flushes"] += 1   # one backend dispatch round
                self._absorb_byzantine()
            for out in outs:
                if isinstance(out, BlockFailure):
                    raise QuorumError(out.reason)
            return req.build(outs)

    # ----------------------------------------------------- submit / flush
    def submit(self, a, b, *, key=None,
               survivors: Optional[np.ndarray] = None,
               encoded: bool = False, m: Optional[int] = None) -> int:
        """Queue one matmul; returns its request id (serve via :meth:`flush`)."""
        req = self._build_request(a, b, key=key, survivors=survivors,
                                  encoded=encoded, m=m)
        self._pending.append(req)
        return req.rid

    def pending(self) -> int:
        return len(self._pending)

    def flush(self) -> Dict[int, torch.Tensor]:
        """Serve every queued request; returns ``{rid: result}``.

        All queued blocks go to the backend as ONE op list (one engine
        flush on the batched backend).  Failures are isolated per request
        in :attr:`failures` (``rid → reason``, replaced each flush).

        When attrition has pushed the backing pool below N and a free
        re-tune prefers another block side, queued requests are tiled
        again at the new optimum first (``stats["retiles"]``).
        """
        with spans.span("mpc.call") as sp:
            self._maybe_retile()
            queue, self._pending = self._pending, []
            self.failures = {}
            ops: List[BlockOp] = []
            for req in queue:
                ops.extend(req.ops)
            _describe(sp, ops)
            outs = []
            if ops:
                outs = self.backend.run_blocks(self._serve_ops(ops))
                self.stats["flushes"] += 1   # one backend dispatch round
                self._absorb_byzantine()

            results: Dict[int, torch.Tensor] = {}
            pos = 0
            for req in queue:
                chunk = outs[pos: pos + len(req.ops)]
                pos += len(req.ops)
                bad = next((o for o in chunk if isinstance(o, BlockFailure)),
                           None)
                if bad is not None:
                    self.failures[req.rid] = bad.reason
                    continue
                results[req.rid] = req.build(chunk)
            return results

    # ------------------------------------------------------- replan drain
    def _maybe_retile(self) -> None:
        """Adopt a drain re-tune before tiling reaches the backend.

        Engages when the session has reported attrition, the backend can
        answer a free re-tune (``drain_spec``: the batched backend, through
        its engine's pools) and that re-tune's block side differs from the
        in-flight spec's.  Queued requests holding their raw operands are
        then rebuilt under the new spec (same rids); their survivor masks,
        sized for the old worker set, are dropped (``stats
        ["masks_dropped"]``).  A pool spec keeps its dead set (the new spec
        carries the same roster); an int-N spec's dead slots name workers
        of the old protocol, so the set and the backend's view reset.
        """
        if not self._pending or not self._dead:
            return
        raws = [r.raw for r in self._pending
                if r.raw is not None and r.raw["m"] is None]
        if not raws:
            return
        # the largest queued workload drives the block side
        pick = max(raws, key=lambda raw: raw["batch"] * int(
            np.prod(raw["shape"], dtype=np.int64)))
        new = self.backend.drain_spec(
            self.spec, pick["shape"], batch=pick["batch"],
            cost=self._cost, tile_budget=self._tile_budget)
        if new is None:
            return
        old_spec, self.spec = self.spec, new
        self.stats["retiles"] += 1
        if old_spec.pool is None:
            self._dead.clear()
            self.backend.fail(frozenset())
        queue, self._pending = self._pending, []
        for req in queue:
            raw = req.raw
            if raw is None or raw["m"] is not None:
                self._pending.append(req)  # pinned block side: keep
                continue
            surv = raw["survivors"]
            if surv is not None:
                surv = None
                self.stats["masks_dropped"] += 1
            self.stats["blocks"] -= len(req.ops)
            self._pending.append(self._build_request(
                raw["a"], raw["b"], key=raw["key"], survivors=surv,
                encoded=raw["encoded"], m=None, rid=req.rid))

    # -------------------------------------------------- request construction
    @spans.spanned("mpc.request")
    def _build_request(self, a, b, *, key, survivors, encoded,
                       m, rid: Optional[int] = None) -> _Request:
        f = self.spec.field
        dev = self.device
        raw_a, raw_b = a, b      # the caller's operands, for a re-tile
        a = a.to(dev) if isinstance(a, torch.Tensor) else torch.tensor(a, device=dev)
        b = b.to(dev) if isinstance(b, torch.Tensor) else torch.tensor(b, device=dev)
        a_vec, b_vec = a.ndim == 1, b.ndim == 1
        if a_vec:
            a = a[None, :]
        if b_vec:
            b = b[:, None]
        if a.ndim < 2 or b.ndim < 2 or a.shape[-1] != b.shape[-2]:
            raise ValueError(
                f"matmul shapes do not align: {tuple(a.shape)} x "
                f"{tuple(b.shape)}")
        out_dtype = torch.result_type(a, b)
        if not out_dtype.is_floating_point:
            out_dtype = torch.float64
        ea = a if encoded else f.encode(a)
        eb = b if encoded else f.encode(b)
        ea = torch.remainder(ea.to(torch.int64), f.p)
        eb = torch.remainder(eb.to(torch.int64), f.p)

        kdim = a.shape[-1]
        if b.ndim == 2:
            # the common serving shape: fold every leading dim of a into
            # rows — one 2-D tiled product regardless of batch depth
            lead = tuple(a.shape[:-1])
            r = int(np.prod(lead, dtype=np.int64)) if lead else 1
            pieces = [(ea.reshape(r, kdim), eb)]
            out_shape: Tuple[int, ...] = lead + (b.shape[-1],)
        else:
            bshape = tuple(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
            eab = ea.broadcast_to(bshape + tuple(a.shape[-2:])).reshape(
                (-1,) + tuple(a.shape[-2:]))
            ebb = eb.broadcast_to(bshape + tuple(b.shape[-2:])).reshape(
                (-1,) + tuple(b.shape[-2:]))
            pieces = [(eab[i], ebb[i]) for i in range(eab.shape[0])]
            out_shape = bshape + (a.shape[-2], b.shape[-1])
            r = a.shape[-2]
        c = b.shape[-1]

        b_folded = b.ndim == 2   # keep only the flag, not the operand
        if min(r, kdim, c) == 0 or not pieces:
            # np.matmul semantics without protocol work: an empty
            # contraction sums to zero, empty rows/cols give empty output
            if survivors is not None:
                self.spec.validate_survivors(survivors)
            zeros = torch.zeros(out_shape, device=dev,
                                dtype=torch.int64 if encoded else out_dtype)
            if b_vec:
                zeros = zeros[..., 0]
            if a_vec:
                zeros = zeros[0] if b_folded else zeros[..., 0, :]
            return self._finish_request([], lambda outs: zeros, rid=rid)

        if m is not None:
            # route the override through the spec so the s|m / t|m rule
            # lives in exactly one place
            block = self.spec.replace(m=int(m)).m
        elif self.spec.m:
            block = self.spec.m
        elif self._cost is not None:
            # a backend whose per-block launch serializes scales the
            # dispatch term of the block search
            cost = self._cost
            scale = self.backend.dispatch_scale(self.spec)
            if scale != 1.0:
                cost = cost.with_dispatch_scale(scale)
            block = choose_block_cost(
                self.spec.s, self.spec.t, self.spec.z, self.spec.n_workers,
                r, kdim, c, cost=cost, batch=len(pieces),
                budget=self._tile_budget, pool=self.spec.pool,
                placement=self.spec.effective_placement)
        else:
            block = choose_block(self.spec.s, self.spec.t, r, kdim, c,
                                 budget=self._tile_budget)
        proto = self.spec.protocol(block)
        tm = TileMap(m=block, r=r, k=kdim, c=c)
        eff: Optional[np.ndarray] = None
        if survivors is not None:
            self.spec.validate_survivors(survivors)  # shape + threshold
            # analysis: allow(host-sync): survivor masks are host data
            eff = np.asarray(survivors, bool)
        base = self._next_key(key)
        self._calls += 1

        n_ops = tm.n_blocks * len(pieces)
        # exact-fit single block: no tiling, no padding, no reassembly —
        # the facade collapses to one protocol call on the operands
        clean = n_ops == 1 and (r, kdim, c) == (block, block, block)
        ops: List[BlockOp] = []
        for pa, pb in pieces:
            if clean:
                ops.append(BlockOp(proto=proto, a=pa.T, b=pb, key=base,
                                   survivors=eff))
                continue
            ta = tile_blocks(pa, block)          # [gr, gk, m, m]
            tb = tile_blocks(pb, block)          # [gk, gc, m, m]
            for i in range(tm.gr):
                for j in range(tm.gc):
                    for l in range(tm.gk):
                        # single-block calls consume the caller's key
                        # directly: identical to protocol.run
                        bk = base if n_ops == 1 else fold_in(base, len(ops))
                        ops.append(BlockOp(
                            proto=proto, a=ta[i, l].T, b=tb[l, j],
                            key=bk, survivors=eff))

        n_pieces = len(pieces)

        @spans.spanned("mpc.build")
        def build(outs: List[torch.Tensor]) -> torch.Tensor:
            per = tm.n_blocks
            mats = (outs if clean else
                    [assemble(tm, outs[i * per:(i + 1) * per], f.p)
                     for i in range(n_pieces)])
            y = mats[0] if n_pieces == 1 else torch.stack(mats)
            if encoded:
                out = y.reshape(out_shape)
            else:
                out = f.decode(y, products=2).reshape(out_shape).to(out_dtype)
            if b_vec:
                out = out[..., 0]
            if a_vec:
                out = out[0] if b_folded else out[..., 0, :]
            return out

        raw = {"a": raw_a, "b": raw_b, "key": key, "survivors": survivors,
               "encoded": encoded, "m": m, "shape": (r, kdim, c),
               "batch": n_pieces}
        return self._finish_request(ops, build, raw=raw, rid=rid)

    def _finish_request(self, ops: List[BlockOp], build: Callable, *,
                        raw: Optional[Dict[str, Any]] = None,
                        rid: Optional[int] = None) -> _Request:
        if rid is None:  # a drain re-tile keeps the caller-visible rid
            rid = self._next_rid
            self._next_rid += 1
            self.stats["matmuls"] += 1
        self.stats["blocks"] += len(ops)
        return _Request(rid=rid, ops=ops, build=build, raw=raw)


# ================================================================= connect
def connect(spec: MPCSpec, backend: str = "local", *, device=None,
            **opts) -> MPCSession:
    """Open an :class:`MPCSession` on a backend and a device.

    ``device``: where every block runs; default the card (raises when
    there is none).  ``backend``: ``"local"`` (``mode="fused"|"kernel"|
    "reference"``, optional ``injector``), ``"batched"`` (the
    :class:`~repro_torch.mpc.engine.MPCEngine`: optional ``spares``,
    ``max_batch``, ``wave_scalars``, ``inflight``, ``injector``,
    ``recorder``), ``"remote"`` (workers behind the framed socket
    transport: optional ``spawn="thread"|"process"``, ``pipelined``,
    ``recorder``, see :class:`~repro_torch.mpc.backends.RemoteBackend`),
    ``"sharded"`` (requires ``mesh=``, a
    :class:`~repro_torch.parallel.compat.Mesh`; optional ``axis``,
    ``wire_dtype``, ``prg_masks``; the session runs on
    ``mesh.devices[0]``, and a ``device`` that disagrees raises) or a
    constructed backend.  Session
    options: ``key`` (int seed or ``torch.Generator``, the base of every
    per-call key), ``tile_budget`` (the shape adapter's dispatch cap) and
    ``cost`` (a :class:`~repro_torch.mpc.autotune.CostModel`: block sides
    come from the cost-model search, and the batched engine re-tunes under
    the same weights on attrition).  A spec with ``adversaries > 0``
    routes every decode through MAC verification; ``injector`` (a
    :class:`~repro_torch.mpc.byzantine.FaultInjector`) corrupts shares on a
    seeded schedule to prove it.
    """
    from .backends import resolve_backend

    key = opts.pop("key", None)
    tile_budget = opts.pop("tile_budget", DEFAULT_TILE_BUDGET)
    cost = opts.pop("cost", None)
    if backend in ("sharded", "remote") and (
            spec.adversaries or opts.get("injector") is not None):
        # neither the mesh runner nor the wire transport carries the MAC
        # tags verification needs; serving unverified shares under a
        # Byzantine spec would defeat the budget: fail at connect time
        raise ValueError(
            f"the {backend} backend does not verify shares: use the local "
            "or batched backend for specs with adversaries > 0 / an "
            "injector")
    if backend == "sharded" or getattr(backend, "name", None) == "sharded":
        be = resolve_backend(backend, **opts)    # raises without a mesh
        dev = be.mesh.devices[0]                 # where the blocks decode
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"device={device!r} disagrees with the mesh, "
                             f"whose first device is {dev}")
    else:
        dev = resolve_device(device)
        if backend in ("batched", "remote"):
            opts.setdefault("device", dev)       # the engine runs where we do
            if cost is not None and backend == "batched":
                # the engine re-tunes under the objective it serves with
                opts.setdefault("cost", cost)
        be = resolve_backend(backend, **opts)
    engine = getattr(be, "engine", None)
    if cost is not None and engine is not None and engine.cost is None:
        # a constructed batched backend: align its re-tune objective with
        # the session's, unless its engine was built with its own
        engine.cost = cost
    return MPCSession(spec, be, device=dev, key=key, tile_budget=tile_budget,
                      cost=cost)
