"""The client-side dealer: spawn, frame, and queue per-device traffic
(port of ``repro/transport/dealer.py``).

A :class:`Dealer` owns the N workers of ONE serving protocol: it spawns
them (``spawn="thread"`` — loopback socketpairs, the test/CI mode; or
``spawn="process"`` — real OS processes connecting back over TCP), ships
each its plan parameters, and exposes per-device send queues plus one
shared inbox the protocol driver (:mod:`repro_torch.transport.driver`)
drains.  The workers compute on the dealer's torch device: thread mode
hands it to each :func:`~repro_torch.transport.worker.worker_main`,
process mode passes its name to each spawned process.

Concurrency model (DESIGN.md §13): every link runs a writer thread
(drains that device's send queue — the dealer never blocks on a slow
socket) and a reader thread (pushes complete frames into the shared
inbox).  The driver is the only consumer; link death surfaces as a
``__down__`` frame in the same inbox, so timeouts, replies and deaths
serialize through one event stream.
"""
from __future__ import annotations

import queue
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..mpc.errors import QuorumError
from .framing import WIRE_VERSION, TransportClosed, recv_msg, send_msg

#: how long a spawned worker may take to come up (process mode pays a
#: full interpreter, the torch import and a CUDA context on the card
#: before its ``ready``)
READY_TIMEOUT_S = 120.0

#: how long ``close`` waits, in all, for stopped worker threads to return
JOIN_TIMEOUT_S = 5.0


class WorkerDown(RuntimeError):
    """A worker link died or was evicted (carried in-band as __down__)."""


class WorkerLink:
    """One device's socket + its writer/reader threads."""

    def __init__(self, device: int, sock: socket.socket,
                 inbox: "queue.Queue", *, process=None,
                 delay_s: float = 0.0):
        self.device = int(device)
        self.sock = sock
        self.alive = True
        self.delay_s = float(delay_s)
        self._process = process
        self._sendq: "queue.Queue" = queue.Queue()
        self._writer = threading.Thread(
            target=self._write_loop, daemon=True,
            name=f"transport-w{device}-tx")
        self._reader = threading.Thread(
            target=self._read_loop, args=(inbox,), daemon=True,
            name=f"transport-w{device}-rx")
        self._writer.start()
        self._reader.start()

    def send(self, meta: Dict, arrays: Optional[Dict] = None) -> None:
        """Queue one frame for this device (never blocks on the wire)."""
        self._sendq.put((meta, arrays))

    def _write_loop(self) -> None:
        while True:
            item = self._sendq.get()
            if item is None:
                return
            try:
                send_msg(self.sock, *item)
            except OSError:
                return  # reader surfaces the death through the inbox

    def _read_loop(self, inbox: "queue.Queue") -> None:
        import time as _time

        try:
            while True:
                meta, arrays = recv_msg(self.sock, timeout=None)
                if self.delay_s > 0.0 and "mono" in meta:
                    # simulated propagation: deliver each reply delay_s
                    # after the worker SENT it.  Sleeping to the stamped
                    # deadline (not a flat sleep) keeps in-flight replies
                    # overlapped exactly like a real wire — back-to-back
                    # frames arrive back-to-back, just later.
                    dt = meta["mono"] + self.delay_s - _time.monotonic()
                    if dt > 0:
                        _time.sleep(dt)
                inbox.put((self.device, meta, arrays))
        except (TransportClosed, OSError):
            inbox.put((self.device, {"kind": "__down__"}, {}))

    def kill(self) -> None:
        """Tear the link down (eviction / dealer shutdown)."""
        if not self.alive:
            return
        self.alive = False
        self._sendq.put(None)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        proc = self._process
        if proc is not None:
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.terminate()


def _plan_doc(spec, m: int, device: int) -> Dict:
    return {"kind": "plan", "wire": WIRE_VERSION, "scheme": spec.scheme,
            "s": spec.s, "t": spec.t, "z": spec.z, "lam": spec.lam,
            "p": spec.field.p, "frac_bits": spec.field.frac_bits,
            "m": m, "device": device}


class Dealer:
    """N spawned workers + their links for one serving protocol."""

    def __init__(self, proto, *, spawn: str = "thread",
                 delay_s: float = 0.0, device=None):
        from ..mpc.field import resolve_device

        if spawn not in ("thread", "process"):
            raise ValueError(
                f"unknown spawn mode {spawn!r}: expected thread|process")
        self.proto = proto
        self.spawn = spawn
        self.device = resolve_device(device)
        self.delay_s = float(delay_s)  # simulated per-round link latency
        self.inbox: "queue.Queue" = queue.Queue()
        self.links: Dict[int, WorkerLink] = {}
        self._threads: List[threading.Thread] = []
        self._reports = None
        self._closed = False
        n = proto.n_workers
        if spawn == "thread":
            self._spawn_threads(n)
        else:
            self._spawn_processes(n)
        spec, m = proto.spec, proto.m
        for device, link in self.links.items():
            link.send(_plan_doc(spec, m, device))
        self._await_ready(n)

    # ------------------------------------------------------------ spawning
    def _spawn_threads(self, n: int) -> None:
        from .worker import worker_main

        for device in range(n):
            ours, theirs = socket.socketpair()
            th = threading.Thread(target=worker_main,
                                  args=(theirs, self.device), daemon=True,
                                  name=f"transport-worker-{device}")
            th.start()
            self._threads.append(th)
            self.links[device] = WorkerLink(device, ours, self.inbox,
                                            delay_s=self.delay_s)

    def _spawn_processes(self, n: int) -> None:
        import multiprocessing as mp

        from .worker import process_worker

        if self.device.type == "cuda":
            # N fresh processes would each start nvcc on a clean checkout
            # and read as stalls: build every kernel library first (one
            # parallel nvcc per source; nothing to do when built)
            from ..kernels import _build

            _build.build()
        ctx = mp.get_context("spawn")
        # each process reports its launch counters here as it exits: the
        # card's work done outside this process, read without the wire
        self._reports = ctx.SimpleQueue()
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.bind(("127.0.0.1", 0))
        listener.listen(n)
        listener.settimeout(READY_TIMEOUT_S)
        host, port = listener.getsockname()
        procs = []
        for device in range(n):
            proc = ctx.Process(target=process_worker,
                               args=(host, port, device, str(self.device),
                                     self._reports),
                               daemon=True)
            proc.start()
            procs.append(proc)
        try:
            for _ in range(n):
                sock, _addr = listener.accept()
                meta, _ = recv_msg(sock, timeout=READY_TIMEOUT_S)
                if meta.get("kind") != "hello":
                    raise TransportClosed(
                        f"expected hello, got {meta.get('kind')!r}")
                device = int(meta["device"])
                sock.settimeout(None)
                self.links[device] = WorkerLink(
                    device, sock, self.inbox, process=procs[device],
                    delay_s=self.delay_s)
        finally:
            listener.close()

    def _await_ready(self, n: int) -> None:
        ready = set()
        while len(ready) < n:
            try:
                device, meta, _ = self.inbox.get(timeout=READY_TIMEOUT_S)
            except queue.Empty:
                raise WorkerDown(
                    f"only {len(ready)}/{n} workers ready within "
                    f"{READY_TIMEOUT_S}s") from None
            if meta.get("kind") == "__down__":
                raise WorkerDown(f"worker {device} died during handshake")
            if meta.get("kind") == "ready":
                ready.add(device)

    # ------------------------------------------------------------- serving
    def alive_devices(self) -> List[int]:
        return sorted(d for d, ln in self.links.items() if ln.alive)

    def send(self, device: int, meta: Dict,
             arrays: Optional[Dict] = None) -> None:
        link = self.links[device]
        if not link.alive:
            raise WorkerDown(f"worker {device} is evicted")
        link.send(meta, arrays)

    def evict(self, device: int) -> None:
        """Kill one link; the driver folds the death into its blocks."""
        self.links[device].kill()

    def chaos(self, device: int, **doc) -> None:
        """Script a fault into one worker (test hook; FIFO per socket, so
        the chaos lands before any frame queued after it)."""
        self.send(device, {"kind": "chaos", **doc})

    def require_full_strength(self) -> None:
        """Phase-2 work needs every slot: raise when any link is down."""
        n = self.proto.n_workers
        alive = len(self.alive_devices())
        if alive < n:
            raise QuorumError(
                f"dealer group has {alive}/{n} workers alive",
                quorum=n, alive=alive)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for link in self.links.values():
            if link.alive:
                link.send({"kind": "stop"})
            link.kill()
        # a worker thread still inside torch when the interpreter exits
        # aborts the process: let the stopped ones finish (a scripted
        # stall keeps sleeping and is left behind)
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for th in self._threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))

    def worker_reports(self) -> List[Dict]:
        """After :meth:`close` in process mode: one dict per worker process
        that exited through its loop, ``{"slot", "device", "launches",
        "instances"}`` (its kernel counters over its life); ``[]`` in
        thread mode, where the counters are this process's own."""
        out = []
        q = self._reports
        while q is not None and not q.empty():
            out.append(q.get())
        return sorted(out, key=lambda r: r["slot"])

    def __del__(self):  # best-effort: tests/examples that forget close()
        try:
            self.close()
        except Exception:
            pass


def slot_devices(spec, slots) -> Tuple[int, ...]:
    """Translate protocol slots to the ids the elastic layer speaks:
    roster device ids under a pool placement, the slots themselves
    otherwise (mirrors ``LocalBackend``'s liar reporting)."""
    placement = spec.effective_placement
    if placement is None:
        return tuple(int(s) for s in slots)
    return tuple(int(placement[int(s)]) for s in slots)


def slot_klass(spec, slot: int) -> str:
    """The worker-class name behind one protocol slot (``klass`` for
    recorded :class:`~repro_torch.sim.trace.PhaseSample` rows): the roster
    class under a pool spec, the scheme name otherwise."""
    if spec.pool is None:
        return spec.scheme
    placement = spec.effective_placement
    return spec.pool.workers[placement[int(slot)]].name


def survivor_bool(n: int, alive, extra_mask: Optional[np.ndarray]
                  ) -> np.ndarray:
    """AND an alive-device set into an optional caller survivor mask."""
    out = np.zeros(n, bool)
    out[list(alive)] = True
    if extra_mask is not None:
        # analysis: allow(host-sync): survivor masks are host data already
        out &= np.asarray(extra_mask, bool)
    return out
