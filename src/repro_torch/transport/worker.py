"""The out-of-process worker loop on torch (port of
``repro/transport/worker.py``).

One worker owns one protocol slot ``n``.  It receives its plan
parameters over the wire, resolves the SAME data-independent tables the
dealer uses (:func:`repro_torch.mpc.planner.get_plan` is deterministic
and element-equal to the reference planner, so a worker rebuilds the
tables without ever shipping them) and then serves blocks until the
socket closes:

* ``shares``  → run the plan's ``worker_compute`` stage on its
  ``[1, m/t, m/s]`` share slice (one ``modmatmul_batched`` launch at
  W = 1) and reply with its G-mix contribution ``g_n[n'] = c_{n,n'} ·
  H(α_n) mod p`` for every receiver ``n'``: one ``polyeval`` launch, the
  slot's G-mix column ``[N, 1]`` against ``vec H(α_n)`` ``[1, (m/t)²]``;
* ``ipoint``  → store this slot's aggregated ``I(α_n)`` and echo it back
  (phase-3 download); the echo is what makes a late or dead worker a
  *phase-3* loss the survivor mask absorbs;
* ``chaos``   → test-only fault hooks (die or stall at a scripted block),
  driving the same schedules ``byzantine.FaultInjector`` serializes;
* ``stop``    → exit the loop.

The torch device a worker computes on is an argument of the process (or
thread), never a field of the wire: both packages speak one wire.
Replies are cached per block id, so a dealer retry is answered
idempotently from the cache instead of recomputing.
"""
from __future__ import annotations

import contextlib
import select
import socket
import time
from typing import Dict, Optional, Tuple

import torch

from ..kernels.polyeval import polyeval
from .framing import WIRE_VERSION, TransportClosed, recv_msg, send_msg

#: per-worker reply cache depth (blocks); must cover the dealer's largest
#: in-flight window plus retry skew
REPLY_CACHE = 8


def _build_state(doc: Dict, device: torch.device):
    """Resolve (spec, plan, stages, slot) from a ``plan`` message."""
    from ..mpc.api import MPCSpec
    from ..mpc.field import Field

    if doc.get("wire") != WIRE_VERSION:
        raise TransportClosed(
            f"wire version {doc.get('wire')!r} != {WIRE_VERSION}")
    spec = MPCSpec(
        s=int(doc["s"]), t=int(doc["t"]), z=int(doc["z"]),
        lam=None if doc["lam"] is None else int(doc["lam"]),
        scheme=str(doc["scheme"]),
        field=Field(p=int(doc["p"]), frac_bits=int(doc["frac_bits"])),
        m=int(doc["m"]))
    plan = spec.plan()
    return spec, plan, plan.stages(device), int(doc["device"])


class _Chaos:
    """Scripted fault hooks for one worker (test-only).

    ``die_block``/``die_after``: close the connection while serving that
    block: ``after="shares"`` is a phase-2 loss (no G contribution ever
    leaves), ``after="ipoint"`` a phase-3 loss (the I point exists but
    the download dies).  ``stall_block``/``stall_s``: sleep before
    replying, long enough to trip the dealer's deadline, or until the
    dealer hangs up.
    """

    def __init__(self):
        self.die_block: Optional[int] = None
        self.die_after = "shares"
        self.stall_block: Optional[int] = None
        self.stall_s = 0.0

    def update(self, doc: Dict) -> None:
        if "die_block" in doc:
            self.die_block = (None if doc["die_block"] is None
                              else int(doc["die_block"]))
            self.die_after = str(doc.get("die_after", "shares"))
        if "stall_block" in doc:
            self.stall_block = (None if doc["stall_block"] is None
                                else int(doc["stall_block"]))
            self.stall_s = float(doc.get("stall_s", 0.0))

    def maybe_stall(self, bid: int, sock: socket.socket) -> None:
        """Sleep ``stall_s`` before serving ``bid``; a dealer that hangs up
        meanwhile (eviction, close) ends the stall with the link, so no
        stalled thread outlives its dealer."""
        if self.stall_block is None or bid != self.stall_block:
            return
        # wait for the peer's hang-up, not for data: a retry queued behind
        # the stall must not end it
        hangup = select.poll()
        hangup.register(sock, select.POLLHUP | getattr(select, "POLLRDHUP", 0))
        if hangup.poll(int(self.stall_s * 1e3)):
            raise TransportClosed("dealer hung up during a stall")

    def dies_at(self, bid: int, point: str) -> bool:
        return self.die_block is not None and bid == self.die_block \
            and self.die_after == point


def g_row(stages, g_col: torch.Tensor, f_a: torch.Tensor, f_b: torch.Tensor,
          p: int) -> torch.Tensor:
    """One worker's phase-2 upload: ``H(α_n) = F_A(α_n)·F_B(α_n)`` (the
    ``worker_compute`` stage on its ``[1, m/t, m/s]`` slice), then
    ``g[n', :] = c_{n,n'} · vec H(α_n) mod p`` for every receiver as one
    K = 1 ``polyeval`` launch; ``[N, (m/t)²]`` on the shares' device."""
    h = stages.worker_compute(f_a[None], f_b[None])            # [1, mt, mt]
    return polyeval(g_col, h.reshape(1, -1), p=p)


def worker_main(sock: socket.socket, device) -> None:
    """Serve one worker slot over ``sock`` until EOF/``stop``, computing
    on ``device`` (a torch device or its name).

    Runs as a thread target (``spawn="thread"``) or as the body of a
    spawned process (:func:`process_worker`).  A new thread's current
    CUDA device is the first card whatever the session's is, so the loop
    enters ``device`` explicitly.  All compute goes through the plan's
    stages: the same kernels the in-process backends launch.
    """
    dev = torch.device(device)
    ctx = (torch.cuda.device(dev) if dev.type == "cuda"
           else contextlib.nullcontext())
    stages = None
    slot = -1
    g_col = None
    p = 0
    chaos = _Chaos()
    cache: Dict[Tuple[int, str], Tuple[Dict, Dict]] = {}
    try:
        with ctx:
            while True:
                meta, arrays = recv_msg(sock, timeout=None)
                kind = meta.get("kind")
                if kind == "stop":
                    return
                if kind == "chaos":
                    chaos.update(meta)
                    continue
                if kind == "plan":
                    _, plan, stages, slot = _build_state(meta, dev)
                    p = plan.p
                    # this slot's G-mix scalars c_{n, n'}, one per receiver
                    g_col = torch.from_numpy(
                        plan.g_mix[slot].reshape(-1, 1).copy()).to(dev)
                    cache.clear()
                    send_msg(sock, {"kind": "ready", "device": slot,
                                    "wire": WIRE_VERSION})
                    continue
                bid = int(meta["block"])
                cached = cache.get((bid, kind))
                if cached is not None:  # dealer retry: answer idempotently
                    cached[0]["mono"] = time.monotonic()
                    send_msg(sock, *cached)
                    continue
                chaos.maybe_stall(bid, sock)
                if kind == "shares":
                    t0 = time.perf_counter()
                    f_a = torch.from_numpy(arrays["f_a"]).to(dev)
                    f_b = torch.from_numpy(arrays["f_b"]).to(dev)
                    # the reply leaves as host bytes: .numpy() after the
                    # copy to the host, which waits for the kernels
                    # analysis: allow(host-sync): the reply is host bytes
                    g = g_row(stages, g_col, f_a, f_b, p).cpu().numpy()
                    us = (time.perf_counter() - t0) * 1e6
                    if chaos.dies_at(bid, "shares"):
                        return
                    reply = ({"kind": "gvec", "block": bid, "device": slot,
                              "compute_us": us}, {"g": g})
                elif kind == "ipoint":
                    if chaos.dies_at(bid, "ipoint"):
                        return
                    reply = ({"kind": "result", "block": bid,
                              "device": slot}, {"i": arrays["i"]})
                else:
                    raise TransportClosed(f"unknown frame kind {kind!r}")
                cache[(bid, reply[0]["kind"])] = reply
                while len(cache) > REPLY_CACHE:
                    cache.pop(next(iter(cache)))
                # send stamp for the dealer's simulated-latency delivery
                # (CLOCK_MONOTONIC is system-wide, so process mode works)
                reply[0]["mono"] = time.monotonic()
                send_msg(sock, *reply)
    except (TransportClosed, OSError):
        return  # dealer hung up / killed the link: a clean worker death
    finally:
        try:
            sock.close()
        except OSError:
            pass


def process_worker(host: str, port: int, slot: int, device: str,
                   report) -> None:
    """Entry point for ``spawn="process"`` workers.

    Top-level so the multiprocessing ``spawn`` start method can pickle
    it; connects back to the dealer's listener and identifies its slot
    with a ``hello`` frame before entering :func:`worker_main` on
    ``device`` (a device name: ``"cuda:0"``, ``"cpu"``).  When the loop
    ends, the process puts its kernel launch counters on ``report`` (a
    multiprocessing queue, outside the wire).
    """
    from ..kernels import instance_counts, launch_counts

    sock = socket.create_connection((host, port), timeout=60.0)
    send_msg(sock, {"kind": "hello", "device": int(slot),
                    "wire": WIRE_VERSION})
    sock.settimeout(None)
    worker_main(sock, device)
    report.put({"slot": int(slot), "device": str(torch.device(device)),
                "launches": launch_counts(), "instances": instance_counts()})
