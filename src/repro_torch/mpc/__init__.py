"""Executable CMPC layer on torch: field, Lagrange machinery, 3-phase protocols.

Port of ``repro/mpc``.  The public surface is :class:`MPCSpec` +
:func:`connect`: one frozen parameterization object and one session verb
set (``matmul`` / ``submit`` / ``flush`` / ``fail`` /
``validate_survivors``) over the ``local``, ``sharded``, ``batched`` and
``remote`` backends, with
rectangular and batched operands handled by the shape adapter
(:mod:`.tiling`).  Sessions run on the card unless the caller passes
``device="cpu"``.

``MPCSpec.tune`` / :func:`tune` search the code family under the paper's
cost model (:class:`CostModel`, heterogeneous :class:`WorkerPool`
rosters); ``MPCSpec(adversaries=a)`` MAC-verifies every decode and
:class:`FaultInjector` drives seeded corruption schedules; batched
serving lives in :mod:`.engine`, elastic pools in :mod:`.elastic`.

Plans (alphas, reconstruction weights, Vandermonde tables, their device
copies, staged programs, survivor-table LRUs) are memoized process-wide in
:mod:`.planner`.
"""
from .api import MPCSession, MPCSpec, connect
from .autotune import CostModel, TuneResult, tune
from .byzantine import FaultInjector
from .errors import AdversaryBudgetError, MaskShapeError, QuorumError
from .workers import WorkerClass, WorkerPool
from .field import ACC_WINDOW, DEFAULT_FIELD, Field, P_DEFAULT, P_MERSENNE31, acc_window
from .planner import (
    ProtocolPlan,
    ProtocolStages,
    build_plan,
    cache_clear,
    cache_info,
    get_plan,
    plan_from_arrays,
)
from .protocol import AGECMPCProtocol

__all__ = [
    "ACC_WINDOW",
    "AdversaryBudgetError",
    "CostModel",
    "DEFAULT_FIELD",
    "FaultInjector",
    "Field",
    "MPCSession",
    "MPCSpec",
    "MaskShapeError",
    "QuorumError",
    "TuneResult",
    "WorkerClass",
    "WorkerPool",
    "tune",
    "P_DEFAULT",
    "P_MERSENNE31",
    "acc_window",
    "connect",
    "AGECMPCProtocol",
    "MPCEngine",
    "ProtocolPlan",
    "ProtocolStages",
    "build_plan",
    "cache_clear",
    "cache_info",
    "get_plan",
    "plan_from_arrays",
]


def __getattr__(name: str):
    # the engine pulls in elastic and protocol; keep the package import light
    if name == "MPCEngine":
        from .engine import MPCEngine

        return MPCEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
