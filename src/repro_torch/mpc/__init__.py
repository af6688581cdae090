"""Executable CMPC layer on torch: field, Lagrange machinery, 3-phase protocols.

Port of ``repro/mpc``.  The public surface is :class:`MPCSpec` +
:func:`connect`: one frozen parameterization object and one session verb
set (``matmul`` / ``submit`` / ``flush`` / ``fail`` /
``validate_survivors``) over the ``local`` backend, with rectangular and
batched operands handled by the shape adapter (:mod:`.tiling`).  Sessions
run on the card unless the caller passes ``device="cpu"``.

Plans (alphas, reconstruction weights, Vandermonde tables, their device
copies, staged programs, survivor-table LRUs) are memoized process-wide in
:mod:`.planner`.
"""
from .api import MPCSession, MPCSpec, connect
from .errors import AdversaryBudgetError, MaskShapeError, QuorumError
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
    "DEFAULT_FIELD",
    "Field",
    "MPCSession",
    "MPCSpec",
    "MaskShapeError",
    "QuorumError",
    "P_DEFAULT",
    "P_MERSENNE31",
    "acc_window",
    "connect",
    "AGECMPCProtocol",
    "ProtocolPlan",
    "ProtocolStages",
    "build_plan",
    "cache_clear",
    "cache_info",
    "get_plan",
    "plan_from_arrays",
]
