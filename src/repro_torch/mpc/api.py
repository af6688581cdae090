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

Not ported yet, and refused with ``NotImplementedError``: worker pools and
placements, ``MPCSpec.tune`` and cost-model block search (ROADMAP queue 1,
item 6), adversary budgets (item 7), and every backend but ``local``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .errors import MaskShapeError, QuorumError
from .field import DEFAULT_FIELD, Field, fold_in, resolve_device
from .planner import PlanKey, ProtocolPlan, _resolve_code, get_plan
from .tiling import DEFAULT_TILE_BUDGET, TileMap, assemble, choose_block, tile_blocks

SCHEMES = ("age", "entangled", "polydot")


def _not_ported(pool, placement, adversaries) -> None:
    """Refuse the options whose slices the port does not have yet."""
    if pool is not None or placement is not None:
        raise NotImplementedError(
            "worker pools and placements come with the autotuner and worker "
            "pools slice (ROADMAP queue 1, item 6)")
    if adversaries:
        raise NotImplementedError(
            "adversary budgets come with the Byzantine decode slice "
            "(ROADMAP queue 1, item 7)")


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
    pool, placement, adversaries : the reference's heterogeneous-pool and
             Byzantine fields; only their defaults are ported so far
    """

    s: int
    t: int
    z: int
    lam: Optional[int] = None
    scheme: str = "age"
    field: Field = DEFAULT_FIELD
    m: Optional[int] = None
    pool: Optional[object] = None
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
        a = self.adversaries
        if isinstance(a, bool) or not isinstance(a, (int, np.integer)) or a < 0:
            raise ValueError(f"adversaries must be an int >= 0, got {a!r}")
        _not_ported(self.pool, self.placement, a)

    # ------------------------------------------------------------ identity
    def replace(self, **kw) -> "MPCSpec":
        """A copy with the given fields replaced (validated again)."""
        return dataclasses.replace(self, **kw)

    def plan_key(self, m: Optional[int] = None) -> PlanKey:
        """The process-wide planner-cache key for this spec (+ block side)."""
        return (self.scheme, self.s, self.t, self.z, self.lam,
                self.field.p, self._block(m))

    def group_key(self, m: Optional[int] = None) -> Tuple:
        """Serving-group identity: the plan key (no pools or budgets yet)."""
        return self.plan_key(m)

    def slots_for(self, devices) -> Tuple[int, ...]:
        """Worker ids are protocol slots (no pool translation yet)."""
        return tuple(sorted(int(d) for d in devices))

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
    def frac_bits(self) -> int:
        return self.field.frac_bits

    # ----------------------------------------------------------- factories
    @classmethod
    def tune(cls, n_workers: Optional[int] = None, z: int = None,
             shape=None, **kw) -> "MPCSpec":
        raise NotImplementedError(
            "MPCSpec.tune comes with the autotuner and worker pools slice "
            "(ROADMAP queue 1, item 6)")

    def plan(self, m: Optional[int] = None) -> ProtocolPlan:
        """The cached data-independent tables for this spec at block ``m``."""
        return get_plan(self.scheme, self.s, self.t, self.z, self.lam,
                        self.field, self._block(m))

    def protocol(self, m: Optional[int] = None):
        """An :class:`~repro_torch.mpc.protocol.AGECMPCProtocol` for
        block ``m``."""
        from .protocol import AGECMPCProtocol

        return AGECMPCProtocol.from_spec(self, m=m)

    # ------------------------------------------------- survivor validation
    def validate_survivors(self, survivors) -> np.ndarray:
        """First ``t²+z`` alive worker indices for a survivor mask.

        Raises :class:`~repro_torch.mpc.errors.MaskShapeError` (a
        ``ValueError``) on a mis-shaped mask and
        :class:`~repro_torch.mpc.errors.QuorumError` (a ``RuntimeError``)
        when fewer than the quorum survive.  The returned prefix is the
        decode quorum; its frozen tuple keys the plan's survivor LRU.
        """
        need = self.recovery_threshold
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
            raise QuorumError(
                f"only {len(idx)} workers alive < threshold {need}",
                spec=self, quorum=need, alive=len(idx),
                slots=np.nonzero(~alive)[0])
        return idx[:need]


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
    """One logical session matmul: its block ops + how to reassemble."""

    rid: int
    ops: List[BlockOp]
    build: Callable[[List[torch.Tensor]], torch.Tensor]


# ================================================================= session
class MPCSession:
    """One verb set over a backend, on one device (obtain via
    :func:`connect`).

    * :meth:`matmul` — rectangular/batched float (or field) matmul;
    * :meth:`submit` / :meth:`flush` — queue many matmuls, serve together;
    * :meth:`fail` — report worker attrition (folded into later decodes);
    * :meth:`validate_survivors` — the spec's public mask validation.
    """

    def __init__(self, spec: MPCSpec, backend, *, device, key=None,
                 tile_budget: int = DEFAULT_TILE_BUDGET):
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
        self.failures: Dict[int, str] = {}
        self.stats = {"matmuls": 0, "blocks": 0, "flushes": 0}

    # ------------------------------------------------------------- helpers
    def validate_survivors(self, survivors) -> np.ndarray:
        """Public survivor-mask validation (see ``MPCSpec``)."""
        return self.spec.validate_survivors(survivors)

    def fail(self, workers) -> None:
        """Mark workers (protocol slots) dead for every later matmul/flush;
        the dead set folds into each decode's survivor mask."""
        self._dead.update(int(w) for w in np.atleast_1d(
            # analysis: allow(host-sync): worker ids are host data
            np.asarray(workers, np.int64)).tolist())
        self.backend.fail(frozenset(self._dead))

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
        req = self._build_request(a, b, key=key, survivors=survivors,
                                  encoded=encoded, m=m)
        outs = []
        if req.ops:
            outs = self.backend.run_blocks(self._serve_ops(req.ops))
            self.stats["flushes"] += 1   # one backend dispatch round
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

        All queued blocks go to the backend as ONE op list.  Failures are
        isolated per request in :attr:`failures` (``rid → reason``,
        replaced each flush).
        """
        queue, self._pending = self._pending, []
        self.failures = {}
        ops: List[BlockOp] = []
        for req in queue:
            ops.extend(req.ops)
        outs = []
        if ops:
            outs = self.backend.run_blocks(self._serve_ops(ops))
            self.stats["flushes"] += 1   # one backend dispatch round

        results: Dict[int, torch.Tensor] = {}
        pos = 0
        for req in queue:
            chunk = outs[pos: pos + len(req.ops)]
            pos += len(req.ops)
            bad = next((o for o in chunk if isinstance(o, BlockFailure)), None)
            if bad is not None:
                self.failures[req.rid] = bad.reason
                continue
            results[req.rid] = req.build(chunk)
        return results

    # -------------------------------------------------- request construction
    def _build_request(self, a, b, *, key, survivors, encoded,
                       m) -> _Request:
        f = self.spec.field
        dev = self.device
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
            return self._finish_request([], lambda outs: zeros)

        if m is not None:
            # route the override through the spec so the s|m / t|m rule
            # lives in exactly one place
            block = self.spec.replace(m=int(m)).m
        elif self.spec.m:
            block = self.spec.m
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

        return self._finish_request(ops, build)

    def _finish_request(self, ops: List[BlockOp],
                        build: Callable) -> _Request:
        rid = self._next_rid
        self._next_rid += 1
        self.stats["matmuls"] += 1
        self.stats["blocks"] += len(ops)
        return _Request(rid=rid, ops=ops, build=build)


# ================================================================= connect
def connect(spec: MPCSpec, backend: str = "local", *, device=None,
            **opts) -> MPCSession:
    """Open an :class:`MPCSession` on a backend and a device.

    ``device``: where every block runs; default the card (raises when
    there is none).  ``backend``: ``"local"`` (``mode="fused"|"kernel"|
    "reference"``) or a constructed backend; the reference's other
    backends raise ``NotImplementedError`` naming their ROADMAP item.
    Session options: ``key`` (int seed or ``torch.Generator``, the base of
    every per-call key) and ``tile_budget`` (the shape adapter's dispatch
    cap).  ``cost`` (cost-model block search) is not ported yet.
    """
    from .backends import resolve_backend

    dev = resolve_device(device)
    key = opts.pop("key", None)
    tile_budget = opts.pop("tile_budget", DEFAULT_TILE_BUDGET)
    if opts.pop("cost", None) is not None:
        raise NotImplementedError(
            "cost-model block search comes with the autotuner and worker "
            "pools slice (ROADMAP queue 1, item 6)")
    be = resolve_backend(backend, **opts)
    return MPCSession(spec, be, device=dev, key=key, tile_budget=tile_budget)
