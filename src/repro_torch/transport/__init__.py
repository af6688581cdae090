"""Out-of-process worker transport on torch (port of ``repro/transport``).

The N workers of a plan as separate processes (or loopback threads):
length-prefixed framing (:mod:`.framing`, a verbatim copy, so both
packages speak one wire), the worker serve loop (:mod:`.worker`), the
client-side dealer with per-device send/recv queues (:mod:`.dealer`),
and the pipelined protocol driver with deadline/retry/backoff
degradation into the survivor-mask / elastic-replan path
(:mod:`.driver`).  Workers and dealer compute on the session's torch
device.  Consumed through ``connect(spec, backend="remote")``: see
:class:`repro_torch.mpc.backends.RemoteBackend`.
"""
from .dealer import Dealer, WorkerDown, WorkerLink
from .driver import BlockError, PhaseLoss, run_blocks
from .framing import WIRE_VERSION, TransportClosed, recv_msg, send_msg
from .worker import process_worker, worker_main

__all__ = [
    "Dealer", "WorkerDown", "WorkerLink",
    "BlockError", "PhaseLoss", "run_blocks",
    "WIRE_VERSION", "TransportClosed", "recv_msg", "send_msg",
    "process_worker", "worker_main",
]
