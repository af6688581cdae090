"""The wire protocol driver on torch: pipelined (or phase-barriered) block
serving (port of ``repro/transport/driver.py``).

One :func:`run_blocks` call serves a list of coded block products over a
:class:`~repro_torch.transport.dealer.Dealer`'s links, replicating the
staged in-process protocol exactly:

* **phase 1**: the dealer runs the plan's ``encode`` stage on its device
  (two ``polyeval`` launches), draws the block's aggregate mask from the
  same generator at once, in both modes (``field.random(gen, (z, m/t,
  m/t))``, exactly as the local ``exchange`` draws it, so a block's
  I-points equal the local path's for the same key), and streams each
  worker its ``(F_A(α_n), F_B(α_n))`` slice as a ``shares`` frame;
* **phase 2**: each worker computes ``H(α_n)`` with the same stage and
  returns its G-mix row; the dealer sums the rows on its device and adds
  the aggregate-mask term ``vand_g_secret · mask`` (one ``polyeval``
  launch), yielding every ``I(α_{n'})``;
* **phase 3**: the dealer scatters each worker its I point and decodes
  from the echoes through the plan's ``decode`` stage, the survivors'
  rows gathered on the device.

**Pipelining** (the default): up to ``window`` blocks are in flight, so
block ``b+1``'s encode and block ``b−1``'s decode run on the dealer while
block ``b`` sits in worker compute / on the wire, and the mask term is
computed during the workers' phase-2 window.  ``pipelined=False`` is the
honest phase-barriered baseline: one block at a time, each phase
completed for every device before the next starts, decode fenced; only
the mask term's product waits for the last G row (the draw does not).

**Failure semantics**: every expected reply carries a deadline; a silent
device is re-asked up to ``retries`` times with exponential backoff (the
worker answers duplicates idempotently from its reply cache), then
evicted.  A death *before* a block's G row arrived is a **phase-2 loss**
(no I point on any device is complete without it): that block, and every
block not yet past exchange, returns :class:`PhaseLoss` so the caller
can route the dead slots through ``ElasticPool.fail_devices`` → retune/
replan.  A death *after* (only the I-point echo missing) is a **phase-3
loss**, absorbed by the survivor mask.
"""
from __future__ import annotations

import dataclasses
import queue
import time
from typing import Callable, Dict, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from ..kernels.polyeval import polyeval
from ..mpc.errors import MaskShapeError, QuorumError
from ..mpc.field import as_int64, generator
from .dealer import Dealer, slot_klass, survivor_bool


@dataclasses.dataclass(frozen=True)
class PhaseLoss:
    """A block whose phase-2 contribution was lost to a worker death.

    ``slots`` are *protocol slots*; the caller translates them to roster
    device ids (``spec.effective_placement``) before reporting attrition.
    """

    slots: Tuple[int, ...]


BlockOutcome = Union[object, PhaseLoss, "BlockError"]


@dataclasses.dataclass(frozen=True)
class BlockError:
    """A block the driver could not decode (quorum below threshold)."""

    reason: str


@dataclasses.dataclass
class _Expect:
    """One outstanding reply: what we wait for and how to re-ask."""

    kind: str
    deadline: float
    attempts: int
    resend: Callable[[], None]


@dataclasses.dataclass
class _Block:
    """One in-flight block's dealer-side state."""

    bid: int
    op: object                       # BlockOp
    mask: torch.Tensor               # [z, mt²] aggregate mask, drawn at start
    i_acc: torch.Tensor              # [N, mt²] running G-row sum (device)
    await_g: Set[int]                # slots whose G row is outstanding
    term: Optional[torch.Tensor] = None      # [N, mt²] mask term
    i_pts: Optional[torch.Tensor] = None     # [N, mt, mt] once exchanged
    i_host: Optional[np.ndarray] = None      # the same, the scatter's bytes
    await_r: Set[int] = dataclasses.field(default_factory=set)
    got_r: Set[int] = dataclasses.field(default_factory=set)
    f_a: Optional[np.ndarray] = None     # kept for retry resends
    f_b: Optional[np.ndarray] = None
    sent_t: Dict[int, float] = dataclasses.field(default_factory=dict)
    compute_us: Dict[int, float] = dataclasses.field(default_factory=dict)
    ipoint_t: Dict[int, float] = dataclasses.field(default_factory=dict)


#: reply deadline: generous enough that a worker's first call (its plan's
#: tables copied to the card, its kernel libraries loaded) never reads as
#: a stall
DEADLINE_S = 30.0
RETRIES = 2
BACKOFF = 2.0
WINDOW = 2


def _host(x: torch.Tensor) -> np.ndarray:
    """A device tensor as C-order int64 host bytes for a frame payload."""
    # analysis: allow(host-sync): wire boundary, shares become payloads
    return np.ascontiguousarray(x.cpu().numpy())


def run_blocks(dealer: Dealer, ops, *, pipelined: bool = True,
               window: int = WINDOW, deadline_s: float = DEADLINE_S,
               retries: int = RETRIES, backoff: float = BACKOFF,
               recorder=None) -> Tuple[List[BlockOutcome], Dict[str, int]]:
    """Serve ``ops`` (BlockOps with masks already folded) over the wire.

    Returns ``(outcomes, stats)``: one decoded ``Y`` (on the dealer's
    device) / :class:`PhaseLoss` / :class:`BlockError` per op, in order,
    plus the driver's counters (``retries``, ``evictions``,
    ``phase3_absorbed``) and ``dealer_us``, the dealer's time outside its
    wait for replies (encode, the copies to and from the host, the G-row
    sums, the mask term and decode).  ``recorder`` (duck-typed
    ``record(**kw)``) receives dealer-aggregate ``encode``/``decode``
    samples (``device=-1``) and per-device ``compute`` / ``exchange``
    samples with the paper's per-worker scalar counts, so
    ``sim.calibrate`` can fit measured wire rates per worker class.
    """
    proto = dealer.proto
    plan, spec = proto.plan, proto.spec
    dev = dealer.device
    stages = plan.stages(dev)
    vand_secret = plan.tables(dev)["vand_g_secret"]
    n, s, t, z, m, p = (plan.n_workers, plan.s, plan.t, plan.z, plan.m,
                        plan.p)
    mt = m // t
    placement = spec.effective_placement
    # paper per-worker scalar counts: ξ/N for compute, ζ/N for exchange
    compute_scalars = int(m ** 3 / (s * t * t))
    exchange_scalars = (n - 1) * m * m // (t * t)
    encode_scalars = 2 * n * (m * m) // (s * t)
    decode_scalars = (t * t + z) * mt * mt

    outcomes: List[BlockOutcome] = [None] * len(ops)
    stats = {"retries": 0, "evictions": 0, "phase3_absorbed": 0,
             "dealer_us": 0.0}
    if not ops:
        return outcomes, stats
    t_run = time.perf_counter()
    alive: Set[int] = set(dealer.alive_devices())
    dead: Set[int] = set(range(n)) - alive
    in_flight: Dict[int, _Block] = {}
    expects: Dict[Tuple[int, int], _Expect] = {}
    next_bid = 0
    barrier = not pipelined
    if barrier:
        window = 1

    def record(device: int, phase: str, scalars: int, us: float) -> None:
        if recorder is None:
            return
        if device < 0:
            klass = spec.scheme
            dev_id = -1
        else:
            klass = slot_klass(spec, device)
            dev_id = device if placement is None else int(placement[device])
        recorder.record(device=dev_id, klass=klass, phase=phase,
                        scalars=scalars, us=us, lanes=1)

    def expect(slot: int, bid: int, kind: str,
               resend: Callable[[], None]) -> None:
        expects[(slot, bid)] = _Expect(
            kind=kind, deadline=time.monotonic() + deadline_s,
            attempts=0, resend=resend)

    def start(bid: int) -> None:
        op = ops[bid]
        gen = generator(op.key, dev)
        t0 = time.perf_counter()
        f_a, f_b = stages.encode(as_int64(op.a, dev), as_int64(op.b, dev),
                                 gen)
        # the exchange's draw, at once: nothing else may draw from a
        # shared generator between the secrets and the mask
        mask = plan.field.random(gen, (z, mt, mt)).reshape(z, mt * mt)
        # the per-worker share slices leave the process as frame payloads
        f_a, f_b = _host(f_a), _host(f_b)
        record(-1, "encode", encode_scalars,
               (time.perf_counter() - t0) * 1e6)
        st = _Block(bid=bid, op=op, mask=mask,
                    i_acc=torch.zeros((n, mt * mt), dtype=torch.int64,
                                      device=dev),
                    await_g=set(alive), f_a=f_a, f_b=f_b)
        in_flight[bid] = st
        now = time.monotonic()
        for slot in sorted(alive):
            dealer.send(slot, {"kind": "shares", "block": bid},
                        {"f_a": f_a[slot], "f_b": f_b[slot]})
            st.sent_t[slot] = now
            expect(slot, bid, "gvec",
                   lambda sl=slot, s_=st: dealer.send(
                       sl, {"kind": "shares", "block": bid},
                       {"f_a": s_.f_a[sl], "f_b": s_.f_b[sl]}))
        if pipelined:
            # overlap: the mask term computes during the workers' phase-2
            # window instead of serializing after the last G row
            st.term = polyeval(vand_secret, mask, p=p)

    def finish_exchange(st: _Block) -> None:
        if st.term is None:          # barriered: strictly after phase 2
            st.term = polyeval(vand_secret, st.mask, p=p)
        st.f_a = st.f_b = None       # retry window for shares is over
        # N G rows and the term, each < p: the sum stays far below 2^63
        st.i_pts = torch.remainder(st.i_acc + st.term, p).reshape(n, mt, mt)
        st.i_acc = st.term = None
        st.i_host = _host(st.i_pts)
        st.await_r = set(alive)
        now = time.monotonic()
        for slot in sorted(alive):
            dealer.send(slot, {"kind": "ipoint", "block": st.bid},
                        {"i": st.i_host[slot]})
            st.ipoint_t[slot] = now
            expect(slot, st.bid, "result",
                   lambda sl=slot, s_=st: dealer.send(
                       sl, {"kind": "ipoint", "block": s_.bid},
                       {"i": s_.i_host[sl]}))

    def finish_block(st: _Block) -> None:
        mask = survivor_bool(n, st.got_r, st.op.survivors)
        absorbed = n - len(st.got_r)
        try:
            idx = spec.validate_survivors(mask)
        except (QuorumError, MaskShapeError) as e:
            outcomes[st.bid] = BlockError(str(e))
        else:
            stats["phase3_absorbed"] += absorbed
            idx_t, rows_t = plan.survivor_tables(
                tuple(int(i) for i in idx), dev)
            t0 = time.perf_counter()
            y = stages.decode(st.i_pts, idx_t, rows_t)
            if (barrier or recorder is not None) and dev.type == "cuda":
                # the barriered baseline completes each phase before the
                # next block; the pipelined path fences only when timing
                # analysis: allow(host-sync): barrier or recorder only
                torch.cuda.synchronize(dev)
            record(-1, "decode", decode_scalars,
                   (time.perf_counter() - t0) * 1e6)
            outcomes[st.bid] = y
        del in_flight[st.bid]

    def on_gvec(slot: int, st: _Block, meta, arrays) -> None:
        st.i_acc += torch.from_numpy(arrays["g"]).to(dev)
        st.await_g.discard(slot)
        us = float(meta.get("compute_us", 0.0))
        st.compute_us[slot] = us
        record(slot, "compute", compute_scalars, us)
        rtt = (time.monotonic() - st.sent_t.get(slot, 0.0)) * 1e6
        st.sent_t[slot] = rtt        # reused below as the upload leg
        if not st.await_g:
            finish_exchange(st)

    def on_result(slot: int, st: _Block) -> None:
        st.await_r.discard(slot)
        st.got_r.add(slot)
        down = (time.monotonic() - st.ipoint_t.get(slot, 0.0)) * 1e6
        wire = max(0.0, st.sent_t.get(slot, 0.0)
                   - st.compute_us.get(slot, 0.0)) + down
        record(slot, "exchange", exchange_scalars, wire)
        if not st.await_r:
            finish_block(st)

    def on_down(slot: int) -> None:
        if slot in dead:
            return
        dead.add(slot)
        alive.discard(slot)
        for key in [k for k in expects if k[0] == slot]:
            del expects[key]
        lost = tuple(sorted(dead))
        for st in list(in_flight.values()):
            if slot in st.await_g:
                # its G row never arrived: no I point is complete
                outcomes[st.bid] = PhaseLoss(lost)
                del in_flight[st.bid]
            elif st.await_r:
                # only the echo is missing: a phase-3 loss the mask takes
                st.await_r.discard(slot)
                if not st.await_r:
                    finish_block(st)

    def on_timeout() -> None:
        now = time.monotonic()
        for key, exp in [(k, e) for k, e in expects.items()
                         if e.deadline <= now]:
            slot, _bid = key
            if exp.attempts < retries:
                exp.attempts += 1
                stats["retries"] += 1
                exp.resend()
                exp.deadline = now + deadline_s * backoff ** exp.attempts
            else:
                del expects[key]
                stats["evictions"] += 1
                dealer.evict(slot)   # the __down__ frame folds it in

    while True:
        while (next_bid < len(ops) and len(in_flight) < window
               and outcomes[next_bid] is None):
            if dead:
                # every I point needs all N G rows: post-death blocks are
                # phase-2 losses until the caller retunes/replans
                outcomes[next_bid] = PhaseLoss(tuple(sorted(dead)))
                next_bid += 1
                continue
            start(next_bid)
            next_bid += 1
        while next_bid < len(ops) and outcomes[next_bid] is not None:
            next_bid += 1
        if not in_flight and next_bid >= len(ops):
            stats["dealer_us"] += (time.perf_counter() - t_run) * 1e6
            return outcomes, stats
        if expects:
            wait = max(0.0, min(e.deadline for e in expects.values())
                       - time.monotonic())
        else:
            wait = deadline_s
        t_wait = time.perf_counter()
        try:
            slot, meta, arrays = dealer.inbox.get(timeout=wait)
        except queue.Empty:
            stats["dealer_us"] -= (time.perf_counter() - t_wait) * 1e6
            on_timeout()
            continue
        stats["dealer_us"] -= (time.perf_counter() - t_wait) * 1e6
        kind = meta.get("kind")
        if kind == "__down__":
            on_down(slot)
            continue
        st = in_flight.get(meta.get("block"))
        if st is None:               # stale duplicate of a finished block
            continue
        expects.pop((slot, st.bid), None)
        if kind == "gvec" and slot in st.await_g:
            on_gvec(slot, st, meta, arrays)
        elif kind == "result" and slot in st.await_r:
            on_result(slot, st)
